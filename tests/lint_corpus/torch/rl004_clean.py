"""Clean twin of rl004_bad.py: metadata reads, device-side selects and
ops of a size known without the data in the tagged code; the host-side
count syncs by design and is untagged."""
import numpy as np
import torch


def helper(x: torch.Tensor):
    return torch.where(x.sum() > 0, x, 0)


class Sim:
    def step(self, x: torch.Tensor, n: int, extra=None):
        """One tick.

        repro-torch-lint: sync-free
        """
        if x.shape[0] > 0 and x.ndim == 2:
            x = x - 1
        if x.dtype == torch.int32 and x.device.type == "cuda":
            x = x + 1
        if x.numel() and len(x) > n and extra is None:
            x = helper(x)
        k = int(x.shape[0])
        assert n >= 0
        return torch.clamp(x, max=k)

    def inflight(self, x: torch.Tensor) -> int:
        """Host-side count: syncs by design, reached from no tagged code."""
        return int((x != 0).sum())


def gather_hits(x: torch.Tensor, counts: torch.Tensor, n: int, table):
    """Sizes the host knows: fixed counts, ``output_size``, integer
    indices, transfers to the card, another module's ``unique``.

    repro-torch-lint: sync-free
    """
    mask = x > 0
    a = torch.where(mask, x, 0)
    b = x[x.argsort()], x[..., :n], x[0], x[mask.long()]
    c = x.repeat_interleave(2), torch.repeat_interleave(x, 3, dim=0)
    d = x.repeat_interleave(counts, output_size=n)
    e = x.to("cuda"), x.to(torch.int32), x.to(device=x.device)
    f = torch.nonzero_static(x, size=n)
    g = np.unique(table)
    return a, b, c, d, e, f, g
