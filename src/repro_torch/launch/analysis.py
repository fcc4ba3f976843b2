"""Roofline terms of a dry-run cell from its counted cost.

Hardware constants: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power
limit, from NVIDIA's H100 data sheet, dense rates without sparsity:

    PEAK_FLOPS  989e12   bf16 tensor-core FLOP/s
    HBM_BW      3.35e12  HBM3 bytes/s
    NVLINK_BW   450e9    NVLink 4 bytes/s per direction (900 GB/s total)

A card set below 700 W runs slower under load; these are the published
peaks, not a measurement.

    compute term    = flops per device / PEAK_FLOPS
    memory term     = bytes per device / HBM_BW

(the reference's third, collective bytes over the link rate, is not
formed here: see below).

The reference reads its FLOPs and bytes from its jaxpr walker
(`launch/jaxpr_cost.py`; here `launch/op_cost.py`) and its collective
bytes from the compiled, SPMD-partitioned HLO (`parse_collective_bytes`
over `compiled.as_text()`, `roofline_from_compiled`).  A torch program
has no compiled HLO and no `cost_analysis()`, and a port mesh
co-locates its shards on one device (ROADMAP §C divergence 10), so no
partitioner inserts collectives that could be counted: the port's
roofline takes (cost, chips), records `collective_bytes` as None with
the reason, and leaves the collective term out of the bound (ROADMAP §C
divergence 17).  No analytic collective model stands in for it: the
reference has none.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12          # bf16 / card (H100 SXM data sheet, 700 W)
HBM_BW = 3.35e12             # bytes/s / card (HBM3, data sheet)
NVLINK_BW = 450e9            # bytes/s / card per direction (NVLink 4)

NO_COLLECTIVES = ("not counted: a torch program has no SPMD-partitioned "
                  "HLO, and a port mesh co-locates its shards")


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device bytes accessed
    chips: int

    # the reference's collective term; none is counted (see above)
    collective_bytes = None
    collective_s = None

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s)

    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the bound: compute_s / max(all)."""
        return self.compute_s / max(self.bound_s, 1e-30)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": None,
            "collectives": None,
            "collectives_note": NO_COLLECTIVES,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": None,
            "dominant": self.dominant,
            "roofline_fraction": self.roofline_fraction(),
            "chips": self.chips,
            "hardware": {"card": "NVIDIA H100 80GB HBM3, 700 W",
                         "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                         "nvlink_bw": NVLINK_BW},
        }


def roofline_from_cost(cost, chips: int) -> Roofline:
    """Roofline terms of a cell whose global program costs `cost` (a
    `launch/op_cost.py::Cost`), spread evenly over `chips` cards (exact
    when every dimension shards; replicated fallbacks make it a slight
    under-estimate per device, as the reference notes for its own)."""
    return Roofline(flops=cost.flops / chips, hbm_bytes=cost.bytes / chips,
                    chips=chips)


def model_flops_estimate(cfg, shape_kind: str, seq: int, batch: int) -> float:
    """MODEL_FLOPS = 6*N_active*D for training, 2*N_active*D for inference
    (D = tokens processed)."""
    from repro_torch.nn.transformer import param_count
    n_total = param_count(cfg)
    # FFN params scale by the active fraction for MoE
    frac = cfg.active_params_per_token_factor()
    if frac < 1.0:
        # approximate: expert params * frac + the rest
        from repro_torch.nn.moe import moe_specs
        from repro_torch.nn.param import param_count as pc
        expert_params = (pc({"e": moe_specs(cfg)["w_gate"]}) * 3
                         * sum(cfg.layer_is_moe()))
        n_active = n_total - expert_params * (1 - frac)
    else:
        n_active = n_total
    tokens = batch * (seq if shape_kind in ("train", "prefill") else 1)
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n_active * tokens
