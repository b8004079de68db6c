"""DSE core of the port: operator model, characterization, MaP, NSGA-II, DSE."""
