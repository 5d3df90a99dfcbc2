"""Swap gains of the pairwise-swap refiner: the gains row and the fused
select step."""
