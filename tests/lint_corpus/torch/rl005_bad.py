"""Known-bad exemplar for RL005: scatters in scatter-free code."""
import torch


def route(inbox: torch.Tensor, dst: torch.Tensor, msgs: torch.Tensor):
    """Deliver each message to its destination lane.

    repro-torch-lint: scatter-free
    """
    out = inbox.clone()
    out.index_put_((dst,), msgs)        # BAD
    out.scatter_(0, dst, msgs)          # BAD
    out.index_copy_(0, dst, msgs)       # BAD
    out.masked_scatter_(dst > 0, msgs)  # BAD
    out[dst] = msgs                     # BAD: subscript assignment
    return out


def accumulate(heat: torch.Tensor, bucket: torch.Tensor):
    """Conflict-heat bump.

    repro-torch-lint: scatter-free
    """
    def bump(h):
        return h.index_add_(0, bucket, torch.ones_like(bucket))  # BAD
    heat[bucket] += 1                   # BAD
    return torch.scatter_add(bump(heat), 0, bucket, bucket)  # BAD
