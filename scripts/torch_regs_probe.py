"""Registers and spills of the head-dim-128 wgmma kernels and of variants
beside them (card's machine: needs ``nvcc``; no GPU is used).

Usage (repo root): ``python3 scripts/torch_regs_probe.py``

ptxas allocates a kernel's registers within what its block leaves each
warp: an SM's 65536 registers are four banks of 16384, warp w runs on
bank w % 4, so a block of 384 threads (3 warps a bank) or of 288 (warps
0, 4 and 8 on one bank) gets 168 registers a thread, whatever
``setmaxnreg`` asks for the consumers, and a block of 256 up to 255. This
script compiles ``torchft_tpu_torch/csrc/flash_attention.cu`` three times,
in parallel, and prints ptxas' registers, spills and warnings for every
entry of each build (a variant with 0 spill bytes fits its block's
budget):

- ``shipped``: the library's kernels (``flash_dkv_wgmma<128>`` is K3 at
  head dim 128, two consumers of 64 keys at 64 queries a product in 256
  threads; ``flash_dq_wgmma<128>`` K2 there, two consumers with two
  64-key chunks in flight each, 256 threads), plus, at 384 threads (a
  producer warpgroup and two consumers), K1 taking 128 keys at once (S 64
  + O 64 + P 32 registers), and ``probe_live<256>`` and
  ``probe_live<288>``: one loop that keeps 192 float32 values live, alone
  in its kernel, at 256 and at 288 threads (K2's layouts at head dim 128
  are built and timed by ``scripts/torch_flash_variants.py``);
- ``k3_nq32_256``: the source with K3's ``kDkvQueries`` at 32 (dK 64 +
  dV 64 + S^T 16 + dP^T 16 + P^T, dS^T 8 each), 256 threads;
- ``k3_nq32_384``: the same with a producer warpgroup and its two-stage
  ring at head dim 128 too, 384 threads.

Of the two K3 builds only the K3 entries are printed.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torchft_tpu_torch.ops import flash_attention as fa  # noqa: E402
from torchft_tpu_torch.utils.platform import build_dir  # noqa: E402

VARIANTS = """
namespace {
// 192 float32 values live across a loop, at kThreads threads a block
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
    probe_live(float* __restrict__ out, const float* __restrict__ in, int n) {
  float acc[192];
#pragma unroll
  for (int i = 0; i < 192; ++i) acc[i] = in[threadIdx.x + i * kThreads];
  for (int k = 0; k < n; ++k) {
    const float x = in[k];
#pragma unroll
    for (int i = 0; i < 192; ++i) acc[i] = fmaf(acc[i], acc[(i + 1) % 192], x);
  }
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < 192; ++i) sum += acc[i];
  out[threadIdx.x] = sum;
}

// K1 taking 128 keys at once, instantiated by taking its address
void* const kProbeVariants[] = {
    reinterpret_cast<void*>(&flash_fwd_wgmma<128, 128>),
    reinterpret_cast<void*>(&probe_live<256>),
    reinterpret_cast<void*>(&probe_live<288>),
};
}  // namespace
extern "C" void* tft_probe_variant(int i) { return kProbeVariants[i]; }
"""


NQ32 = {"constexpr int kDkvQueries = 64;": "constexpr int kDkvQueries = 32;"}
PRODUCER = {
    "constexpr int kDkvProducer = D == 128 ? 0 : kWg;": "constexpr int kDkvProducer = kWg;",
    "constexpr int kDkvStages = D == 128 ? 3 : kStages;": "constexpr int kDkvStages = kStages;",
}
# build name: (text appended to the source, replacements in it, entries printed)
BUILDS = {
    "shipped": (VARIANTS, {}, None),
    "k3_nq32_256": ("", NQ32, "flash_dkv_wgmmaILi128E"),
    "k3_nq32_384": ("", {**NQ32, **PRODUCER}, "flash_dkv_wgmmaILi128E"),
}


def start_build(tmp: str, name: str, extra: str, subs: dict[str, str]) -> subprocess.Popen:
    csrc = os.path.join(tmp, name)
    shutil.copytree(fa.CSRC_DIR, csrc)
    src = os.path.join(csrc, "flash_attention.cu")
    with open(src) as f:
        text = f.read()
    for old, new in subs.items():
        if text.count(old) != 1:
            sys.exit(f"{name}: {old!r} is not in the source exactly once")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text + extra)
    cmd = [
        fa.nvcc_command("")[0], "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-Xptxas", "-v", "-c", "-o", os.path.join(csrc, "probe.o"), src,
    ]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def report(name: str, log: str, only: str | None) -> None:
    for section in log.split("Compiling entry function")[1:]:
        lines = section.splitlines()
        entry = lines[0].strip(" '")
        if only is not None and only not in entry:
            continue
        # e.g. _ZN12_GLOBAL__N_115flash_fwd_wgmmaILi128ELi128EEEv...: K1, D 128, KC 128
        found = re.search(r"(flash_\w+?(?:wgmma|kernel)|probe_live)(I.*?E)E", entry)
        tag = f"{found.group(1)} {found.group(2)}" if found else entry
        stats = [ln.strip() for ln in lines[1:] if "Used" in ln or "spill" in ln or "warning" in ln]
        print(f"[{name}] {tag}: " + " | ".join(stats))
    for line in log.splitlines():
        if "warning" in line and "Compiling" not in line:
            print(f"[{name}] ptxas warning: {line.strip()}")


def main() -> None:
    failed = False
    with tempfile.TemporaryDirectory(dir=build_dir("regs_probe")) as tmp:
        procs = {name: start_build(tmp, name, extra, subs)
                 for name, (extra, subs, _) in BUILDS.items()}
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                print(log)
                print(f"[{name}] nvcc failed (rc={proc.returncode})")
                failed = True
                continue
            report(name, log, BUILDS[name][2])
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
