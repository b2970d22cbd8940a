"""Benchmarks of the port: the paper's CIM tables (Figs. 7-8) and the
fused-against-staged report."""
