"""The fused swap-select step of the pairwise-swap refiner."""
