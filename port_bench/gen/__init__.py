"""Input generators: numpy arrays from a seed, the same for the port and
the reference."""
