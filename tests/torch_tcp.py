"""What the port's TCP tests share: a poll helper and the module-scoped
fixture that holds every test module to closing its brokers and clients.

``TcpClient``'s handler pools (threads ``tcpbus_*`` and ``tcpbus-q_*``)
are not daemon threads, and the JAX package's soak test counts leaked
non-daemon threads; a module that leaves one alive fails that test in a
later module on the same worker. A module uses the fixture by importing
it."""
from __future__ import annotations

import threading
import time

import pytest

TCP_THREADS = ("tcpbus", "broker-")


def wait_for(cond, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def tcp_threads(non_daemon_only: bool = False):
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith(TCP_THREADS) and t.is_alive()
                  and not (non_daemon_only and t.daemon))


@pytest.fixture(scope="module", autouse=True)
def tcp_threads_down():
    """At module end, no non-daemon thread of a TCP client is left (the
    pools of a closed client wind down within a few seconds)."""
    before = set(tcp_threads(non_daemon_only=True))
    yield
    wait_for(lambda: not set(tcp_threads(non_daemon_only=True)) - before, 15.0)
    left = sorted(set(tcp_threads(non_daemon_only=True)) - before)
    assert not left, f"TCP client threads left running: {left}"
