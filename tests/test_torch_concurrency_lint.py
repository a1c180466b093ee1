"""The port's runtime held to the JAX package's concurrency lint.

``torchft_tpu.analysis.concurrency`` is an AST lint over the FT runtime's
threading contract (lock-order cycles, blocking calls under a lock,
futures resolved under a lock, fields written from several threads without
a ``# guarded-by:`` lock or an ``# unguarded-ok:`` hand-off, condition
waits outside a predicate loop, unnamed or unjoined threads). Here it runs
over the port's runtime modules, the telemetry modules among them, and
expects no finding but the few kept below, each with its reason, as the
JAX package keeps its own in ``analysis/baseline.json``. A kept entry that
no longer matches a finding fails too, so the list cannot rot.
"""

import os

import pytest

from torchft_tpu.analysis.base import Baseline
from torchft_tpu.analysis.concurrency import analyze_paths, analyze_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNTIME = (
    "torchft_tpu_torch/manager.py",
    "torchft_tpu_torch/futures.py",
    "torchft_tpu_torch/coordination.py",
    "torchft_tpu_torch/collectives.py",
    "torchft_tpu_torch/collectives_device.py",
    "torchft_tpu_torch/ddp.py",
    "torchft_tpu_torch/parallel/train_step.py",
    "torchft_tpu_torch/checkpointing/_rwlock.py",
    "torchft_tpu_torch/checkpointing/http_transport.py",
    "torchft_tpu_torch/checkpointing/collectives_transport.py",
    "torchft_tpu_torch/profiling.py",
    "torchft_tpu_torch/telemetry/__init__.py",
    "torchft_tpu_torch/telemetry/registry.py",
    "torchft_tpu_torch/telemetry/events.py",
    "torchft_tpu_torch/telemetry/tracing.py",
    "torchft_tpu_torch/telemetry/anatomy.py",
    "torchft_tpu_torch/telemetry/flight.py",
    "torchft_tpu_torch/telemetry/native.py",
    "torchft_tpu_torch/telemetry/fleetdelta.py",
    "torchft_tpu_torch/telemetry/slo.py",
    "torchft_tpu_torch/telemetry/regression.py",
    "torchft_tpu_torch/telemetry/critical_path.py",
    "torchft_tpu_torch/_native.py",
    "torchft_tpu_torch/checkpointing/delta.py",
    "torchft_tpu_torch/ops/flash_attention.py",
    "torchft_tpu_torch/faultinject/core.py",
    "torchft_tpu_torch/telemetry/blackbox.py",
    "torchft_tpu_torch/telemetry/profiler.py",
    "torchft_tpu_torch/telemetry/diagnosis.py",
    "torchft_tpu_torch/telemetry/postmortem.py",
    "torchft_tpu_torch/benchmarks/profiler_overhead.py",
    "torchft_tpu_torch/faultinject/runner.py",
    "torchft_tpu_torch/faultinject/_san_worker.py",
    "torchft_tpu_torch/examples/train_bytes.py",
    "torchft_tpu_torch/multiprocessing.py",
    "torchft_tpu_torch/proxy.py",
    "torchft_tpu_torch/checkpointing/disk.py",
    "torchft_tpu_torch/parameter_server.py",
    "torchft_tpu_torch/parallel/multihost.py",
    "torchft_tpu_torch/launcher.py",
    "torchft_tpu_torch/k8s.py",
    "torchft_tpu_torch/examples/train_ddp.py",
    "torchft_tpu_torch/examples/train_diloco.py",
    "torchft_tpu_torch/examples/train_cifar.py",
)

KEPT = [
    {
        "key": "blocking-under-lock:torchft_tpu_torch/collectives.py:"
               "CollectivesTcp._send_to:_send_frame()",
        "reason": "send_lock is the peer socket's own wire lock: it exists to keep one "
                  "frame's header and payload together on the socket, its only contenders "
                  "are the at most one other op sending to the same peer, and the socket "
                  "carries the op's deadline, so the wait under it is bounded",
    },
    {
        "key": "blocking-under-lock:torchft_tpu_torch/collectives.py:"
               "CollectivesTcp._send_cma:_send_frame()",
        "reason": "the same per-socket send_lock as _send_to: the CMA pull descriptor's "
                  "frame must be whole on the wire",
    },
    {
        "key": "blocking-under-lock:torchft_tpu_torch/collectives.py:"
               "CollectivesTcp._torn_send:*.sock.sendall",
        "reason": "the fault plane's torn frame (a full header and part of the payload) "
                  "must be whole against other senders to that peer, which is what the "
                  "socket's own send_lock is for; the socket is cut right after, so the "
                  "wait under it is one partial frame's",
    },
    {
        "key": "blocking-under-lock:torchft_tpu_torch/manager.py:"
               "Manager.start_quorum:Manager._reusable_early_quorum()",
        "reason": "_reusable_early_quorum calls result() only on the previous quorum "
                  "future once it is seen done under _qf_lock (prev is None or "
                  "prev.done()), so it returns at once; the wait on a future still in "
                  "flight happens with the lock released",
    },
]


def _module_findings(rel):
    active, _, _ = Baseline(suppressions=KEPT).apply(analyze_paths([rel], root=REPO))
    return active


@pytest.mark.parametrize("rel", RUNTIME)
def test_module_passes_the_concurrency_lint(rel):
    assert os.path.exists(os.path.join(REPO, rel)), rel
    active = _module_findings(rel)
    assert not active, [f.render() for f in active]


def test_every_kept_finding_still_occurs():
    _, suppressed, stale = Baseline(suppressions=KEPT).apply(
        analyze_paths(list(RUNTIME), root=REPO))
    assert not stale, stale
    assert len(suppressed) == len(KEPT)


def test_the_lint_sees_a_missing_handoff_annotation():
    """The Manager fields that the main and quorum threads share pass only
    by their annotations: without one, the lint reports the field."""
    path = os.path.join(REPO, "torchft_tpu_torch/manager.py")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    marker = "# unguarded-ok: quorum-thread handoff — staged by the quorum thread"
    assert marker in src
    found = analyze_source("torchft_tpu_torch/manager.py", src.replace(marker, "# staged"))
    assert [f.symbol for f in found if f.rule == "unguarded-shared-write"] == [
        "Manager._pending_state_dict"]
