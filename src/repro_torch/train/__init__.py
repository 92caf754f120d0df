"""Step functions of the port (serving steps only, for now)."""
