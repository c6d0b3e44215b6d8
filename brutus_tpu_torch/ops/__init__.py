"""Compute stages of the port: the funnel likelihood (K2 screen, K3
slab gather, K1 fit), the posterior and its MC kernel (K4)."""
