"""Seconds of the init solve (`optimizer.init_params`), host clock from
a synchronize to its end (it ends reading its result back)."""


def read(facts):
    return facts.init_solve_s
