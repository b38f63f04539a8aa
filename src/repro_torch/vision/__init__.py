"""Vision layers, the network zoo, and parameter conversion."""
