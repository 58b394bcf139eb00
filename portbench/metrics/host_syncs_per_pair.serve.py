"""host_syncs_per_pair: the program's device-to-host synchronisations (its
`host_syncs` counter, over every span of the traced calls) a pair."""

from portbench import program_spans


def read(record, cell):
    return program_spans.per_pair(record, "host_syncs")
