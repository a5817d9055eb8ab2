"""AIR instances."""
