"""Utilities of the port: linear algebra, angles, constraints, derivatives."""
