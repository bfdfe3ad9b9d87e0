"""Pragma exemplar: a suppression without a reason (--strict rejects it)."""


def route(inbox, dst, msgs):
    """repro-torch-lint: scatter-free"""
    # repro-torch-lint: ignore[RL005]
    return inbox.index_put_((dst,), msgs)
