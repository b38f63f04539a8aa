"""FuSeConv operator math, operator IR, NOS scaffolding, OFA elastic
stages and the hybrid-network search."""
