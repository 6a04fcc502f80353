"""Traffic: the scene generator and the one generator that reads a mix."""
