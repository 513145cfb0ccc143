"""Tiny overrides of each cell for rehearsals on the CPU: the test backbone,
small images, small pools. The drivers, the program's plain paths and the
reference run as they do on the card."""

TINY_BACKBONE = {
    "stem_channels": 8,
    "stages": [["cn", 1, 3, 1, 1, 8, 0.0], ["er", 1, 3, 2, 2, 16, 0.0],
               ["ir", 1, 3, 2, 2, 24, 0.25]],
    "num_features": 64,
}
PARAMS = {
    "serve": {"batch": 4, "height": 24, "width": 40, "pool": 2, "sample": 2, "trace_units": 2},
    "interactive": {"height": 24, "width": 40, "pool": 3, "sample": 3, "trace_units": 2},
    "train": {"batch": 4, "crop": 32, "pair_h": 40, "pair_w": 48, "pairs": 3, "batches": 3,
              "trace_units": 1},
}


def overrides(driver: str) -> dict:
    return {"config": {"backbone": TINY_BACKBONE, "predict_size": 32},
            "workload": {"params": PARAMS[driver]}}
