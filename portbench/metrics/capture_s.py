"""Seconds `CycleGraph.prepare` spent warming up and capturing every
variant of the run's cycles (the program's `capture_seconds`)."""


def read(facts):
    return facts.capture_s
