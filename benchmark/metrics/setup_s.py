"""setup_s: loading, seeded weights, inputs and the check steps, which
warm up every shape the window runs, from process start to the window."""


def read(rec):
    return rec["setup_s"]
