"""The port's parameter server against the JAX package's
(``tests/test_parameter_server.py``): the doubling server, on each package's
own collectives, over two sessions with the first client dropped between
them; the replies are equal across the packages, and ``GET /metrics``
serves the port's exposition."""

from __future__ import annotations

import urllib.request
from datetime import timedelta

import numpy as np
import pytest

from torchft_tpu import collectives as JC
from torchft_tpu import parameter_server as JPS
from torchft_tpu_torch import collectives as PC
from torchft_tpu_torch import parameter_server as PPS

T = timedelta(seconds=10)


def _doubling(ps_mod, coll_mod):
    class DoublingPS(ps_mod.ParameterServer):
        """Per session: receive an array, send back twice it, until the
        client hangs up."""

        @classmethod
        def new_collectives(cls):
            return coll_mod.CollectivesTcp(timeout=T)

        def forward(self, session_id, coll):
            while True:
                buf = np.zeros(4, dtype=np.float32)
                coll.recv(buf, src=1, tag=1).wait(T)
                coll.send(buf * 2, dst=1, tag=2).wait(T)

    return DoublingPS


def _sessions(cls):
    """Two sessions, the first client dropped before the second starts;
    returns both replies."""
    ps = cls()
    out = []
    try:
        x = np.arange(4, dtype=np.float32)
        for shift in (0.0, 1.0):
            client = cls.new_session(ps.address())
            try:
                assert client.rank() == 1 and client.size() == 2
                client.send(x + shift, dst=0, tag=1).wait(T)
                reply = np.zeros(4, dtype=np.float32)
                client.recv(reply, src=0, tag=2).wait(T)
                out.append(reply)
            finally:
                client.shutdown()  # the client "dies": the session is dropped
        if isinstance(ps, PPS.ParameterServer):
            port = ps.address().rsplit(":", 1)[1].split("/")[0]
            with urllib.request.urlopen(f"http://localhost:{port}/metrics", timeout=10) as f:
                assert f.headers["Content-Type"].startswith("text/plain")
                assert b"# TYPE" in f.read()
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(f"http://localhost:{port}/nope", timeout=10)
    finally:
        ps.shutdown()
    return out


def test_sessions_and_recovery_as_jax():
    port = _sessions(_doubling(PPS, PC))
    jax = _sessions(_doubling(JPS, JC))
    x = np.arange(4, dtype=np.float32)
    np.testing.assert_array_equal(port[0], x * 2)
    np.testing.assert_array_equal(port[1], (x + 1) * 2)
    for a, b in zip(port, jax):
        assert a.tobytes() == b.tobytes()
