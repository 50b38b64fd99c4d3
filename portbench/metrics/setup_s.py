"""setup_s: process start to the first timed set: imports, CUDA start-up,
knn2's library, rendering the scene, warm-up (s)."""


def read(record):
    return record["setup_s"]
