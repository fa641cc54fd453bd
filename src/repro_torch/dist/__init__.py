"""Analytic traffic model of the aggregation schedule."""
