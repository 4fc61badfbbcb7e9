"""Benchmark of gp_bayesopinf_torch: harness, configurations, traffic, checks,
per-layer readers, frozen counts and the plain reference (see README.md)."""
