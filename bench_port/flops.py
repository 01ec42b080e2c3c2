"""FLOPs of a cell's work, from its configuration file alone: the counts
of the configuration's family (``families/<family>``), which the
``mfu.*`` and ``attn_roofline.*`` readers read through these two calls."""

from __future__ import annotations

from typing import Dict, List, Tuple

from bench_port import families


def unit_flops(config: Dict, mix: Dict) -> float:
    """The FLOPs of one unit of the mix (one request or one batch)."""
    return families.load(config).unit_flops(config, mix)


def attention_sites(config: Dict, mix: Dict) -> List[Tuple[int, int, int, int, int, int]]:
    """(batch, nq, kv_len, heads, head_dim, calls per unit) of every
    attention of one unit."""
    return families.load(config).attention_sites(config, mix)
