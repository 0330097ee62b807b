"""Per-host worker agent: ``python -m blit_torch.agent``.

Counterpart of ``blit/agent.py``, the remote half of the
``backend="remote"`` worker pool (:mod:`blit_torch.parallel.remote`): the
Julia worker process that ``Distributed.addprocs`` starts over ssh and
loads ``WorkerFunctions`` into (reference: src/gbt.jl:28-42).  The same
framing and banner as ``blit``'s agent; each agent is its own process
with its own CUDA context, and loads the kernels that
:mod:`blit_torch.kernels` built (or builds them, one agent at a time).

Protocol (stdin/stdout, logs on stderr):
    banner   := b"BLITAGENT1\\n"            (emitted once at startup; the
                                            client discards any ssh/rc noise
                                            preceding it before framing)
    request  := u64-le length | pickle((fn_path, args, kwargs))
    response := u64-le length | pickle(("ok", result) | ("err", type, msg, tb))

Three enforcement layers keep the wire from invoking arbitrary code or
exhausting memory: ``fn_path`` must resolve inside the ``blit_torch``
package (``blit``'s own callables are refused); the
length header is capped (:data:`MAX_MSG_BYTES`) before any allocation; and
deserialization uses a restricted unpickler whose ``find_class`` admits only
an exact (module, name) allow-list of value constructors / reconstructors /
pure reducers — module-prefix trust would let pickle REDUCE invoke any
callable in an admitted namespace with attacker-chosen arguments.  One
request is serviced at a time, matching the reference's
one-``@spawnat``-at-a-time-per-worker usage.
"""

from __future__ import annotations

import importlib
import io
import os
import pickle
import struct
import sys
import traceback

MAGIC = b"BLITAGENT1\n"
_LEN = struct.Struct("<Q")

# Upper bound on one framed message, enforced BEFORE the body buffer is
# allocated — an untrusted length header must not be able to force multi-GB
# allocations.  Full data slabs legitimately cross the wire (reference
# semantics: whole arrays travel main-ward, src/gbt.jl:78), so the default is
# generous; deployments can tighten or widen it via the env var.
MAX_MSG_BYTES = int(
    os.environ.get("BLIT_AGENT_MAX_MSG_BYTES", str(8 << 30))
)

# Exact globals that may cross the wire, (module, qualname) pairs — NOT
# module prefixes: pickle REDUCE can call any admitted callable with
# attacker-chosen arguments, so each entry must be safe to invoke blind
# (value constructors / reconstructors / pure reducers only).  Requests carry
# regexes/slices/arrays/records; responses carry arrays/records/dicts.
_SAFE_GLOBALS = frozenset({
    # numpy array/scalar reconstruction — numpy 2.x paths...
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy._core.numeric", "_frombuffer"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    # ...and their numpy 1.x spellings (a remote host may run 1.x).
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    # Pure elementwise/axis reducers users pass as ``fqav_func``.
    ("numpy", "sum"), ("numpy", "mean"), ("numpy", "median"),
    ("numpy", "max"), ("numpy", "min"), ("numpy", "amax"),
    ("numpy", "amin"), ("numpy", "nansum"), ("numpy", "nanmean"),
    ("numpy", "std"), ("numpy", "var"),
    ("numpy", "nanmedian"), ("numpy", "nanmax"), ("numpy", "nanmin"),
    # The port's record types that legitimately cross the wire.
    ("blit_torch.inventory", "InventoryRecord"),
    ("blit_torch.naming", "GuppiName"),
    ("blit_torch.config", "SiteConfig"),
})

# Requests additionally carry compiled regex patterns (inventory filters) —
# ``re._compile`` is a pure pattern constructor, acceptable on the *request*
# side where the caller already controls what the agent executes.  Responses
# must not admit it: a compromised peer's reply could hand the client a
# pathological pattern (ReDoS on next use), and no legitimate response needs
# to construct one — results are arrays/records/dicts.
_SAFE_GLOBALS_REQUEST = _SAFE_GLOBALS | {("re", "_compile")}
_SAFE_GLOBALS_RESPONSE = _SAFE_GLOBALS

# A peer claiming a frame beyond this is not merely oversized, it is hostile
# or corrupt (the u64 header can claim up to 16 EiB); draining it would pin
# the reader in a discard loop, so the stream is torn down instead.
_DRAIN_CAP_MULTIPLE = 4
_SAFE_BUILTINS = frozenset(
    {"slice", "complex", "range", "frozenset", "set", "bytearray"}
)


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, file, safe_globals=_SAFE_GLOBALS_REQUEST):
        super().__init__(file)
        self._safe_globals = safe_globals

    def find_class(self, module: str, name: str):
        if (module, name) in self._safe_globals:
            return super().find_class(module, name)
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"agent wire refuses global {module}.{name}"
        )


def ping() -> str:
    """Liveness probe: the cheapest possible round trip through the full
    request path (framing, unpickle, resolve, reply).  The client's health
    check (:meth:`blit_torch.parallel.remote.RemoteWorker._ensure`) calls
    this as an ordinary ``blit_torch.agent.ping`` request — a wedged-but-alive agent that
    cannot answer it within the ping deadline is killed and respawned
    (SURVEY.md §5 "health-checked worker pool")."""
    return "pong"


_PACKAGE = "blit_torch."


def resolve(fn_path: str):
    """Import and return a callable from a ``blit_torch.``-prefixed dotted
    path.  The prefix is matched with its dot, so ``blit.`` paths (the
    JAX package) and look-alikes such as ``blit_torchx.`` are refused."""
    if not fn_path.startswith(_PACKAGE):
        raise PermissionError(
            f"agent refuses non-blit_torch callable {fn_path!r}")
    mod_path, _, name = fn_path.rpartition(".")
    fn = getattr(importlib.import_module(mod_path), name)
    if not callable(fn):
        raise TypeError(f"{fn_path} is not callable")
    return fn


def read_msg(
    stream,
    max_bytes: int = 0,
    safe_globals=_SAFE_GLOBALS_REQUEST,
    drain_oversized: bool = True,
) -> object:
    """Read one framed message.  The length header is untrusted: it is
    validated against ``max_bytes`` (default :data:`MAX_MSG_BYTES`) before
    any buffer is allocated.

    On a modestly oversized header the body is consumed in bounded chunks
    and discarded before :class:`pickle.UnpicklingError` is raised, so the
    stream stays framed and the peer can keep servicing requests.  A claim
    beyond ``_DRAIN_CAP_MULTIPLE`` times the limit is treated as a dead or
    hostile stream — :class:`EOFError` tears the connection down rather than
    letting a 2^64-byte claim pin the reader in a discard loop.

    ``safe_globals`` picks the unpickling allow-list for the direction:
    requests admit compiled regexes (:data:`_SAFE_GLOBALS_REQUEST`, the
    default), responses do not (:data:`_SAFE_GLOBALS_RESPONSE`).

    ``drain_oversized=False`` skips the keep-the-stream-framed drain and
    refuses an oversized frame immediately — for callers who tear the
    connection down on refusal anyway (the client's response path), where
    draining a multi-GiB body through an ssh pipe would be pure waste.
    """
    head = stream.read(_LEN.size)
    if len(head) < _LEN.size:
        raise EOFError
    (n,) = _LEN.unpack(head)
    limit = max_bytes or MAX_MSG_BYTES
    if n > limit:
        if not drain_oversized:
            raise pickle.UnpicklingError(
                f"agent wire message of {n} bytes exceeds the {limit}-byte "
                "limit (stream not drained; tear down the connection)"
            )
        if n > _DRAIN_CAP_MULTIPLE * limit:
            raise EOFError(
                f"agent wire claims a {n}-byte frame (> {_DRAIN_CAP_MULTIPLE}x "
                f"the {limit}-byte limit); tearing down the stream"
            )
        remaining = n
        while remaining > 0:
            chunk = stream.read(min(remaining, 1 << 20))
            if not chunk:
                break  # peer hung up mid-body; refusal below still applies
            remaining -= len(chunk)
        raise pickle.UnpicklingError(
            f"agent wire message of {n} bytes exceeds the "
            f"{limit}-byte limit (BLIT_AGENT_MAX_MSG_BYTES)"
        )
    body = stream.read(n)
    if len(body) < n:
        raise EOFError
    # The frame is fully consumed: any decode failure past this point
    # (truncated pickle → EOFError, UnicodeDecodeError, struct.error, an
    # allow-listed global missing in this numpy version → AttributeError...)
    # leaves the stream correctly framed, so it is reported as a refusal the
    # peer can recover from — never confused with stream-level EOF.
    try:
        return _RestrictedUnpickler(io.BytesIO(body), safe_globals).load()
    except pickle.UnpicklingError:
        raise
    except Exception as e:
        raise pickle.UnpicklingError(
            f"agent wire body failed to decode: {type(e).__name__}: {e}"
        ) from e


def write_msg(stream, obj) -> None:
    body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(_LEN.pack(len(body)))
    stream.write(body)
    stream.flush()


def serve(stdin=None, stdout=None) -> None:
    """Blocking request loop; returns on EOF (pool shutdown / ssh drop)."""
    stdin = stdin or sys.stdin.buffer
    stdout = stdout or sys.stdout.buffer
    while True:
        try:
            msg = read_msg(stdin)
        except (EOFError, OSError):
            # Stream-level trouble (EOF, hostile length claim, dropped
            # pipe/pty): the connection is gone or unframed — end the loop
            # rather than spin err frames into a dead stream.
            return
        except pickle.UnpicklingError as e:
            # A refused or malformed request must not kill the worker:
            # read_msg consumed the framed body (and translates every
            # decode failure to UnpicklingError), so the stream is still
            # framed — report the refusal and keep serving.
            write_msg(stdout, ("err", "UnpicklingError", str(e), ""))
            continue
        try:
            fn_path, args, kwargs = msg
        except (TypeError, ValueError) as e:
            # Decoded fine but not the (fn_path, args, kwargs) shape.
            write_msg(stdout, ("err", type(e).__name__, str(e), ""))
            continue
        # Reserved wire kwarg (never reaches the worker fn): the main
        # process's trace context — this request's span parents onto the pool
        # dispatch span that shipped it.
        tctx = kwargs.pop("_blit_trace", None) if isinstance(kwargs, dict) else None
        try:
            from blit_torch.observability import tracer

            tr = tracer()
            with tr.activate(tctx), tr.span(
                f"agent.{fn_path.rpartition('.')[2]}", fn=fn_path
            ):
                result = resolve(fn_path)(*args, **kwargs)
            write_msg(stdout, ("ok", result))
        except BaseException as e:  # noqa: BLE001 — everything crosses the wire
            write_msg(
                stdout,
                ("err", type(e).__name__, str(e), traceback.format_exc()),
            )


def main() -> None:
    # Anything the worker functions print must not corrupt the framing:
    # repoint sys.stdout at stderr and keep the real fd for the protocol.
    proto_out = sys.stdout.buffer
    sys.stdout = io.TextIOWrapper(sys.stderr.buffer, line_buffering=True)
    # Worker-startup logging: the pool stamps each agent's environment
    # with its worker id, and BLIT_LOG_JSON flips the stderr records to
    # machine-parseable JSON lines so a fleet's logs aggregate without
    # re-parsing the human format.
    try:
        from blit_torch.observability import configure_logging

        configure_logging(
            worker=int(os.environ.get("BLIT_WORKER_ID", "0") or 0),
            json_lines=bool(os.environ.get("BLIT_LOG_JSON")),
        )
    except Exception:  # noqa: BLE001 — logging must not block serving
        pass
    # Handshake: lets the client skip any ssh/rc banner noise ahead of us.
    proto_out.write(MAGIC)
    proto_out.flush()
    serve(sys.stdin.buffer, proto_out)


if __name__ == "__main__":
    main()
