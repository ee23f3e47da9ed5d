"""State initialisation, reductions, state-vector ops and the layer kernel."""
