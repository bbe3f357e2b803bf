"""
The device daemon: one long-lived process that owns the card and serves
the device work of any number of CLI runs over a Unix domain socket.

    python -m sniffles_tpu_torch.parallel.device_daemon --socket /tmp/st.sock &
    SNIFFLES_TPU_DEVICE_SOCKET=/tmp/st.sock python -m sniffles_tpu_torch --input ...

A CLI run of its own pays the device's fixed costs again: the kernel
build check and load, the CUDA context and the service's warmup step.
The daemon pays them once. It holds the port's DeviceServer
(parallel/device_service.py) behind a multiprocessing Listener; every
process of a served run (the CLI parent at --threads 0, each forked
worker at --threads N) opens its own connection, and requests are
served by the server's one dispatcher thread (one card). No process of
a served run creates a CUDA context: the daemon is the only one. It exits
after --idle-timeout seconds without a connected client, or on a
shutdown request.

Copied from sniffles_tpu/parallel/device_daemon.py: serve, DaemonClient,
connect and main. What differs:

* The warmup builds the kernels and creates the context; by default it
  then runs the JAX daemon's full set of warm steps (a call step at 1, 2,
  4 and 8 times the floor width and the fused k = 2 and 4 steps, on zero
  batches). Nothing compiles in torch, but those first launches load the
  kernels' modules and fill the caching allocator. --no-warm-compile
  keeps its name and runs no warm step. A "noop" ping, like any request,
  is answered only after the warmup.
* The device comes from config.torch_device(): the card, or the CPU
  when SNIFFLES_TPU_FORCE_CPU asks for it; with no card and no such
  request main raises, as the CLI does.
* No hedge and no circuit breaker: DaemonClient.degraded and
  last_latency are not ported, so that no fallback hides the device
  (the service left them out for the same reason).
* No fallback: connect() raises when the socket does not answer (the
  JAX package returns None and its runtime makes a service in the parent
  on the first request), and a connection lost during a run raises in
  every wait, so the task fails and the run exits 1.
* The idle reaper polls every half second (JAX: 5 s), and the socket is
  probed before the warmup starts, so a refused daemon creates no
  context.
* A stats answer names the device and counts the daemon's kernel
  launches (DeviceServer.stats).
* The mesh's request kinds place their shards here, from the daemon's
  own environment (parallel/mesh.py mesh_devices:
  SNIFFLES_TPU_MESH_DEVICES, or the cards it sees); a client of a mesh
  run makes no placement check of its own.

Reference mapping: no analogue (the reference is CPU-only); the serving
equivalent of a persistent process that amortises the device's set-up
across runs.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import threading
import time
from multiprocessing.connection import Client, Listener

import numpy as np

from sniffles_tpu_torch.parallel.device_service import (DeviceClient, DeviceRequest,
                                                        DeviceResponse, DeviceServer)

log = logging.getLogger(__name__)

ENV_SOCKET = "SNIFFLES_TPU_DEVICE_SOCKET"

_PING = "noop"
_SHUTDOWN = "__shutdown__"

# seconds between two looks of the idle reaper
_REAP_POLL_S = 0.5


def answers(socket_path: str) -> bool:
    """Whether a listener accepts connections on `socket_path` (and, as a
    side effect, wakes a blocked accept())."""
    try:
        Client(socket_path, family="AF_UNIX").close()
        return True
    except OSError:
        return False


def serve(socket_path: str, idle_timeout: float = 600.0, warm_compile: bool = True,
          device: str = "cuda") -> None:
    """Run the daemon on `device` until a shutdown request or the idle
    timeout. warm_compile=False builds the kernels and creates the
    context but runs no warm step (the tests use it). Raises
    RuntimeError when a live daemon already answers on socket_path."""
    if os.path.exists(socket_path):
        # a live daemon may own this path: unlinking it would orphan a
        # process that holds the card until its idle timeout
        if answers(socket_path):
            raise RuntimeError(
                f"a live device daemon already answers on {socket_path}; "
                f"refusing to start a second claimant (shut it down first "
                f"or use a different --socket)")
        os.unlink(socket_path)
    listener = Listener(socket_path, family="AF_UNIX")
    log.info(f"device daemon listening on {socket_path}")

    server = DeviceServer(device)
    warm_config = None
    if warm_compile:
        # the reference-default kernel parameters; a run with other
        # clustering flags needs no warm step of its own in torch
        from sniffles_tpu_torch.config import SnifflesConfig
        warm_config = SnifflesConfig("--input", "warm.bam", "--vcf", "warm.vcf")
    server.warm_async(warm_config, full=True)

    state = {"last_active": time.monotonic(), "clients": 0, "stop": False}
    state_lock = threading.Lock()

    def reaper():
        while True:
            time.sleep(_REAP_POLL_S)
            with state_lock:
                if state["stop"]:
                    return
                idle = (state["clients"] == 0
                        and time.monotonic() - state["last_active"] > idle_timeout)
                if idle:
                    state["stop"] = True
            if idle:
                log.info("device daemon idle timeout; exiting")
                answers(socket_path)   # unblock listener.accept()
                return

    threading.Thread(target=reaper, daemon=True).start()

    def client_thread(conn):
        send_lock = threading.Lock()
        try:
            while True:
                request = conn.recv()
                with state_lock:
                    state["last_active"] = time.monotonic()
                if not isinstance(request, DeviceRequest):
                    continue
                if request.kind == _SHUTDOWN:
                    with state_lock:
                        state["stop"] = True
                    _safe_send(conn, send_lock, DeviceResponse(payload=np.zeros(1),
                                                               req_id=request.req_id))
                    answers(socket_path)
                    return
                server.submit(request, lambda resp: _safe_send(conn, send_lock, resp))
        except (EOFError, OSError):
            pass
        finally:
            with state_lock:
                state["clients"] -= 1
                state["last_active"] = time.monotonic()
            conn.close()

    try:
        while True:
            conn = listener.accept()
            with state_lock:
                if state["stop"]:
                    conn.close()
                    break
                state["clients"] += 1
            threading.Thread(target=client_thread, args=(conn,), daemon=True).start()
    finally:
        listener.close()
        if os.path.exists(socket_path):
            try:
                os.unlink(socket_path)
            except OSError:
                pass


def _safe_send(conn, lock, msg) -> None:
    try:
        with lock:
            conn.send(msg)
    except OSError:
        log.debug("daemon client went away before response delivery")


class DaemonClient(DeviceClient):
    """Connection to a running device daemon: a DeviceClient (post, wait,
    discard, request) over the socket, whose own thread receives the
    responses; safe for concurrent use from several threads of one
    process. Raises RuntimeError, naming the socket, when the daemon does
    not answer or the connection is lost (every wait then raises)."""

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        try:
            conn = Client(socket_path, family="AF_UNIX")
        except OSError as e:
            raise RuntimeError(f"the device daemon socket {socket_path} ({ENV_SOCKET}) "
                               f"does not answer: {e}") from e
        super().__init__(conn)
        threading.Thread(target=self._recv_loop, daemon=True).start()

    def _lost_text(self, e: BaseException) -> str:
        return (f"the device daemon connection on {self.socket_path} was lost: "
                f"{type(e).__name__}: {e}")

    def _recv_loop(self):
        try:
            while True:
                self.deliver(self._conn.recv())
        except (EOFError, OSError) as e:
            self.lose(self._lost_text(e))

    def post(self, kind: str, payload, meta: dict) -> int:
        try:
            return super().post(kind, payload, meta)
        except OSError as e:
            raise RuntimeError(self._lost_text(e)) from e

    def ping(self, timeout: float = None) -> bool:
        """Block until the daemon has finished its warmup; False on a
        timeout or an error."""
        try:
            self.wait(self.post(_PING, None, {}), timeout=timeout)
            return True
        except (TimeoutError, RuntimeError):
            return False

    def shutdown(self) -> None:
        try:
            self.post(_SHUTDOWN, None, {})
        except RuntimeError:
            pass

    def close(self) -> None:
        self._conn.close()

    def call_task(self, packed: np.ndarray, meta: dict) -> dict:
        return self.request("call_task", packed, meta)


def connect(socket_path: str = None) -> DaemonClient:
    """DaemonClient for `socket_path` (default: $SNIFFLES_TPU_DEVICE_SOCKET);
    None when no daemon is configured. Raises RuntimeError when one is
    configured and does not answer."""
    path = socket_path or os.environ.get(ENV_SOCKET)
    return DaemonClient(path) if path else None


def daemon_request(socket_path: str, kind: str, timeout: float = None):
    """The payload of one request of `kind` (no payload, no meta) to the
    daemon on `socket_path`, over a connection of its own that is closed
    again. No thread is left behind: the CLI asks before it forks its
    workers. Raises RuntimeError naming the socket, and TimeoutError when
    no answer comes within `timeout` (DeviceClient.TIMEOUT by default)."""
    try:
        conn = Client(socket_path, family="AF_UNIX")
    except OSError as e:
        raise RuntimeError(f"the device daemon socket {socket_path} ({ENV_SOCKET}) "
                           f"does not answer: {e}") from e
    try:
        conn.send(DeviceRequest(kind=kind, payload=None, meta={}, req_id=1))
        if not conn.poll(DeviceClient.TIMEOUT if timeout is None else timeout):
            raise TimeoutError(f"the device daemon on {socket_path} did not answer in time")
        response = conn.recv()
    except (EOFError, OSError) as e:
        raise RuntimeError(f"the device daemon connection on {socket_path} was lost: "
                           f"{type(e).__name__}: {e}") from e
    finally:
        conn.close()
    if response.error is not None:
        raise RuntimeError(f"device daemon error: {response.error}")
    return response.payload


def daemon_stats(socket_path: str) -> dict:
    """One stats answer of the daemon on `socket_path` (DeviceServer.stats)."""
    return daemon_request(socket_path, "stats")


def daemon_ping(socket_path: str, timeout: float = None) -> None:
    """Returns once the daemon on `socket_path` has finished its warmup;
    raises as daemon_request does."""
    daemon_request(socket_path, _PING, timeout)


def daemon_shutdown(socket_path: str, timeout: float = None) -> None:
    """Asks the daemon on `socket_path` to exit, and waits for its answer;
    raises as daemon_request does."""
    daemon_request(socket_path, _SHUTDOWN, timeout)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="sniffles_tpu_torch device daemon")
    parser.add_argument("--socket", required=True)
    parser.add_argument("--idle-timeout", type=float, default=600.0)
    parser.add_argument("--no-warm-compile", action="store_true",
                        help="build the kernels and create the context, but run no "
                             "warm step")
    args = parser.parse_args(argv)
    try:
        # the daemon's dispatches are short and latency-critical beside
        # long-running decode workers
        os.nice(-5)
    except OSError:
        pass
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    from sniffles_tpu_torch.config import torch_device
    device = torch_device()
    try:
        serve(args.socket, idle_timeout=args.idle_timeout,
              warm_compile=not args.no_warm_compile, device=device)
    except RuntimeError as e:
        print(f"sniffles_tpu_torch device daemon: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    # a hard exit: the dispatcher thread may still be inside a warm step
    # or a request when serve() returns
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
