"""Entry points (serve, train) and the hardware and mesh tables."""
