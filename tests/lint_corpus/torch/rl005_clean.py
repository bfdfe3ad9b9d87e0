"""Clean twin of rl005_bad.py: sort + searchsorted + gather, and
containers the function builds itself."""
import torch


def route(inbox: torch.Tensor, dst: torch.Tensor, msgs: torch.Tensor):
    """Deliver each message to its destination lane.

    repro-torch-lint: scatter-free
    """
    order = torch.sort(dst, stable=True).indices
    starts = torch.searchsorted(dst[order], torch.arange(inbox.shape[0]))
    out = {}
    out["msgs"] = msgs.gather(0, order)
    parts = []
    parts.append(starts)
    return out, parts


def init_scatter(buf: torch.Tensor, idx: torch.Tensor, v: torch.Tensor):
    # untagged: a one-off scatter outside the routing path
    buf[idx] = v
    return buf.index_put_((idx,), v)
