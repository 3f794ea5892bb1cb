"""Checkpoint IO of the port."""
