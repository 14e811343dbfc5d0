"""Data-parallel group and gradient collectives of the port."""
