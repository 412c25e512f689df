"""Graphs, the delay model, consensus weights, Algorithms 1 and 2 and the
timing engine."""
