"""Plain float32 references of the models the port runs beside its UNet,
for the CPU tests (imports neither package)."""
