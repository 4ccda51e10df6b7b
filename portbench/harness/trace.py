"""What the benchmark reads from a `torch.profiler` trace of a steady
stretch of the timed loop: every device operation (kernel, memset, copy)
with its interval, the union of those intervals (busy time: concurrent
operations count once), device time by group of kernel names, the longest
idle gaps with the host operation running in each, and launches."""

from __future__ import annotations

import bisect

# groups of device operations by name fragment, the first match winning
# (`chip_smoke.py`'s `_KERNEL_GROUPS`, with AdamW's fused kernel first and
# PyTorch's scaled-dot-product attention kernels (flash, memory-efficient,
# cuDNN) ahead of the convolution and matmul groups their names would fall in)
KERNEL_GROUPS = (
    ("optimizer (AdamW)", ("adam",)),
    ("mamba_fused_scan", ("mamba_chunk_kernel", "mamba_combine_kernel", "mamba_fwd_xdbl")),
    ("mamba_fused_scan_bwd pass C", ("mamba_bwd_chunk",)),
    ("mamba_fused_scan_bwd passes A, B, D", ("mamba_bwd_",)),
    ("tap_conv", ("tap_conv_kernel",)),
    ("tap_conv_bwd", ("tap_dfeat_kernel", "tap_dkernel_kernel")),
    ("selective_scan", ("scan_fwd_", "scan_combine_kernel")),
    ("selective_scan_bwd pass C", ("scan_bwd_chunk",)),
    ("selective_scan_bwd passes A, B", ("scan_bwd_",)),
    ("attention", ("flash_fwd", "flash_bwd", "fmha", "attention", "sdpa")),
    ("convolution (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "winograd", "dgrad", "fprop")),
    ("matmul / einsum", ("gemm", "cutlass", "cublas", "sm90_", "sm80_")),
    ("norm", ("norm",)),
    ("interpolate / pool", ("upsample", "pool")),
    ("copy / cat / permute", ("copy", "cat", "transpose", "memcpy")),
    ("memset", ("memset",)),
    ("elementwise / reduce", ("elementwise", "reduce", "vectorized")),
)
# the kernels of each hand-written family, by group
FAMILIES = {
    "mamba_fused": ("mamba_fused_scan", "mamba_fused_scan_bwd pass C",
                    "mamba_fused_scan_bwd passes A, B, D"),
    "tap_conv": ("tap_conv", "tap_conv_bwd"),
    "selective_scan": ("selective_scan", "selective_scan_bwd pass C",
                       "selective_scan_bwd passes A, B"),
}


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for g, frags in KERNEL_GROUPS if any(f in low for f in frags)), "other")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """A profiled stretch: `prof` a finished `torch.profiler.profile`,
    `window_s` the host's seconds around it."""

    def __init__(self, prof, window_s: float):
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in prof.events():
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == cuda:
                dev.append((s, t, e.name))
            elif t > s:
                host.append((s, t, e.name))
        if not dev:
            raise SystemExit("portbench: the profiler recorded no device operation")
        self.window_s = window_s
        self.launches = len(dev)
        busy = _merge([(s, t) for s, t, _ in dev])
        self.busy_s = sum(t - s for s, t in busy) / 1e6
        self.group_ms: dict[str, float] = {}
        for s, t, name in dev:
            g = group_of(name)
            self.group_ms[g] = self.group_ms.get(g, 0.0) + (t - s) / 1e3
        self.gaps = self._gaps(busy, host)

    @staticmethod
    def _gaps(busy, host):
        """{label: idle seconds} over the gaps between busy intervals, each
        labelled by the innermost host operation running at its midpoint."""
        host = sorted(host)
        starts = [s for s, _, _ in host]
        out: dict[str, float] = {}
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            mid = (e0 + s1) / 2
            label = "(between profiled host operations)"
            # the latest-starting operation that still runs at mid: nested
            # operations start after the ones that enclose them
            j = bisect.bisect_right(starts, mid) - 1
            for i in range(j, max(j - 4000, -1), -1):
                if host[i][1] >= mid:
                    label = host[i][2]
                    break
            out[label] = out.get(label, 0.0) + (s1 - e0) / 1e6
        return out

    def family_ms(self, family: str) -> float:
        return sum(self.group_ms.get(g, 0.0) for g in FAMILIES[family])

    def breakdown(self) -> dict:
        ops = sorted(self.group_ms.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[g, ms / 1e3] for g, ms in ops],
                "idle_gaps": [[n[:80], s] for n, s in gaps]}
