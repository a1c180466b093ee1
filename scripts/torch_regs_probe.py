"""Registers and spills of wider wgmma variants at head dim 128 (card's
machine: needs ``nvcc``; no GPU is used).

Usage (repo root): ``python3 scripts/torch_regs_probe.py``

The flash kernels at head dim 128 narrow their score tiles so that each
consumer warpgroup fits the 168 registers a thread that ptxas grants a
384-thread block (``torchft_tpu_torch/csrc/flash_attention.cu``). This
script compiles the same source once more with wider variants instantiated
beside the shipped ones, whose consumers need more than 168 registers:

- K1 taking a stage's 128 keys at once (S 64 + O 64 + P 32 registers,
  under the 232 that ``setmaxnreg`` asks for),
- K2 taking 128 keys at once (S 64 + dP 64 + dQ 64 + dS 32: over 232),
- K3 with two consumers of 64 keys (dK 64 + dV 64 + S^T 16 + dP^T 16 +
  P^T, dS^T 8 each: under 232),

and prints ptxas' registers, spills and warnings for every entry. If a
variant shows 0 spill bytes, ptxas allocated its consumers' registers
under ``setmaxnreg`` beyond 168; if it spills, it did not.
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
// wider variants at head dim 128, instantiated by taking their addresses
void* const kProbeVariants[] = {
    reinterpret_cast<void*>(&flash_fwd_wgmma<128, 128>),
    reinterpret_cast<void*>(&flash_dq_wgmma<128, 128>),
    reinterpret_cast<void*>(&flash_dkv_wgmma<128, 2, 32>),
};
}  // namespace
extern "C" void* tft_probe_variant(int i) { return kProbeVariants[i]; }
"""


def main() -> None:
    with tempfile.TemporaryDirectory(dir=build_dir("regs_probe")) as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(fa.CSRC_DIR, csrc)
        src = os.path.join(csrc, "flash_attention.cu")
        with open(src, "a") as f:
            f.write(VARIANTS)
        cmd = [
            fa.nvcc_command("")[0], "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-Xptxas", "-v", "-c", "-o", os.path.join(tmp, "probe.o"), src,
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        print(log)
        sys.exit(f"nvcc failed (rc={proc.returncode})")
    for section in log.split("Compiling entry function")[1:]:
        lines = section.splitlines()
        name = lines[0].strip(" '")
        # e.g. _ZN12_GLOBAL__N_115flash_fwd_wgmmaILi128ELi128EEEv...: K1, D 128, KC 128
        found = re.search(r"(flash_\w+?(?:wgmma|kernel))(I.*?E)E", name)
        tag = f"{found.group(1)} {found.group(2)}" if found else name
        stats = [ln.strip() for ln in lines[1:] if "Used" in ln or "spill" in ln or "warning" in ln]
        print(f"{tag}: " + " | ".join(stats))
    for line in log.splitlines():
        if "warning" in line and "Compiling" not in line:
            print(f"ptxas warning: {line.strip()}")


if __name__ == "__main__":
    main()
