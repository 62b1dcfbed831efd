"""Seconds the set-up's planning call takes (``repro_torch.core.plan_hybrid`` over
four H100s in one node, the cell's batch and length), host clock around the call."""


def read(run):
    return run.plan_s
