"""The yardstick: the scene with its ground truth, the comparison that
decides `correct`, the card's peaks and the reduction of device traces.
Nothing here imports the program or JAX."""
