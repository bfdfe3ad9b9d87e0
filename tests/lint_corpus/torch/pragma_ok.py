"""Pragma exemplar: both placements, each with a reason."""


def own_line_form(inbox, dst, msgs):
    """repro-torch-lint: scatter-free"""
    # repro-torch-lint: ignore[RL005] one-off init scatter, off the tick path
    return inbox.index_put_((dst,), msgs)


def end_of_line_form(inbox, dst, msgs):
    """repro-torch-lint: scatter-free"""
    return inbox.scatter_(0, dst, msgs)  # repro-torch-lint: ignore[RL005] the same one-off
