"""The port's model stack: parameter specs, layers, attention, the dense LM."""
