"""Datasets and batch loading of the port."""
