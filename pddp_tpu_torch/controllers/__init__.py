"""Controllers of the port: the iLQR functional core."""
