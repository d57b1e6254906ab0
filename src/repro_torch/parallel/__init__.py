"""Cross-rank parts of the port: the sharding rules of a grid of ranks
(``sharding``) and cross-process fault tolerance (``resilience``)."""
