"""Compute stages of the port: the funnel likelihood (K2 screen, K3
slab gather, K1 fit), the dense likelihood (K1 in dense mode), the
posterior and its MC kernel (K4, with its Philox generator)."""
