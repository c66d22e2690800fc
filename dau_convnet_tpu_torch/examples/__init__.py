"""Example scripts of the port (the data generators of the CIFAR example so
far; its training loop is still to come)."""
