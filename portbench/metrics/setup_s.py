"""setup_s: seconds from the start of the run to its first timed call."""


def read(record, cell):
    return record["setup_s"]
