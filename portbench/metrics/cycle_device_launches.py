"""Device operations a replayed cycle launches, over whole refresh
periods: one refresh cycle and (period - 1) plain ones, each counted
in the trace of its replays (a graph launches the same operations at
every replay)."""


def read(facts):
    spans = facts.spans
    if "plain" not in spans or "refresh" not in spans:
        return None
    k = facts.layout.filter_every
    return (spans["refresh"].launches + (k - 1) * spans["plain"].launches
            / facts.plain_cycles) / k
