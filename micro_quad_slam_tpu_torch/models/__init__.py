"""Models of the PyTorch port: the UL flight state machine (behavior.py)
and the closed-loop swarm simulator that drives it (simulator.py)."""
