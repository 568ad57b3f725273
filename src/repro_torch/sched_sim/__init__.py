"""Cluster-simulator support modules shared with the live session:
the cost model, workload generators, the SLO-aware front door, and
the metrics surface.  The discrete-event simulator itself, its
baseline policies and the calibration fit wait for their slice
(ROADMAP), so this package does not import them.
"""
