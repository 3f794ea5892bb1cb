"""Training steps and optimizers of the port."""
