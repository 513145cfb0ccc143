"""Device ms a step of the kernels and copies launched inside the program's
`model.predict` span: the train-mode forward of the backbone and head,
without its backward, traced sub-window."""

from curlbench import spans


def read(r):
    return spans.device_ms(r, "model.predict")
