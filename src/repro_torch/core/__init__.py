"""Serial FMM core: tree, expansions, equations, drivers."""
