"""Known-bad exemplar for RL004: host syncs in code tagged sync-free."""
import torch


def helper(x: torch.Tensor):
    return x.sum().item()               # BAD: step -> _inner -> helper


def _inner(x: torch.Tensor):
    return helper(x) + 1


class Sim:
    def step(self, x: torch.Tensor):
        """One tick.

        repro-torch-lint: sync-free
        """
        if (x > 0).any():               # BAD: `if` on a tensor's value
            x = x - 1
        while x.max() > 3:              # BAD: `while` on a tensor's value
            x = x // 2
        assert x.min() >= 0             # BAD: `assert` on a tensor's value
        k = int(x[0])                   # BAD: int() of a tensor
        y = x.tolist()                  # BAD
        z = x.cpu()                     # BAD
        w = x.numpy()                   # BAD
        v = 1 if x.sum() else 0         # BAD: conditional expression
        return self._tail(x) + _inner(x), k, y, z, w, v

    def _tail(self, x: torch.Tensor):
        return float(x.mean())          # BAD: step -> Sim._tail


def gather_hits(x: torch.Tensor, counts: torch.Tensor):
    """Ops whose output size is the data's.

    repro-torch-lint: sync-free
    """
    mask = x > 0
    a = x[mask]                         # BAD: indexing with a bool tensor
    b = x[:, mask.any(0)]               # BAD: a bool tensor in a tuple
    c = torch.nonzero(x)                # BAD
    d = x.nonzero()                     # BAD
    e = torch.argwhere(x)               # BAD
    f = torch.masked_select(x, mask)    # BAD
    g = torch.unique(x)                 # BAD
    h = x.unique_consecutive()          # BAD
    i = torch.where(mask)               # BAD: one argument
    j = x.repeat_interleave(counts)     # BAD: tensor counts
    k = torch.repeat_interleave(x, counts, dim=0)  # BAD
    m = x.to("cpu")                     # BAD
    n = x.to(device=torch.device("cpu:0"))  # BAD
    torch.cuda.synchronize()            # BAD
    return a, b, c, d, e, f, g, h, i, j, k, m, n
