"""Models: TactileSR (STSR), TPSFNet and the fused serving graph."""
