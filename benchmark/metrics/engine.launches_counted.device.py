"""Launches of one step as the engine counts them (device cell): the
total of its `detail["layers"]`, counted on the first step of the probe
check's engine (program_layers)."""

from benchmark.program_layers import launches


def read(run):
    return launches(run)
