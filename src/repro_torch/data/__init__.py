"""Datasets of the port: numpy copies of the reference's generators."""
