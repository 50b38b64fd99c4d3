"""knn2_roofline: the least time knn2's launches could take on the card
(portbench/reference/roofline.py: operations at 165 TFLOP/s or bytes at
3.35 TB/s, the larger) over the device time of the kernels named knn2 in the
trace, in %. None where the trace holds no knn2 kernel."""


def read(record):
    if not record.get("knn2_s"):
        return None
    return 100.0 * record["knn2_least_s"] / record["knn2_s"]
