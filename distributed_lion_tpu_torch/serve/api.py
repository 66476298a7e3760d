"""Request/response front end of the serving engine: port of
``distributed_lion_tpu/serve/api.py`` (the same strict schema).

Offline request-file mode (the CI-friendly surface): a JSONL file of
requests in, a JSONL file of responses out — the same strict-JSON
discipline as every other artifact (scripts/validate_metrics.py). Each
request line:

    {"id": "r1", "prompt": "Hello", "max_new_tokens": 32, "seed": 0,
     "arrival_tick": 0, "prefix_group": "sys-v2", "deadline_s": 2.5}

``prompt`` (text, run through the tokenizer) or ``tokens`` (explicit ids)
— one of the two is required. ``arrival_tick`` staggers admission for
continuous-batching runs (default 0 = all at start). ``prefix_group`` is
an OPTIONAL routing/accounting tag for requests sharing a prompt prefix
(the ``--prefix_cache`` engine matches by tokens, so the tag never
changes what is shared — under ``--replicas`` the fleet additionally
routes one group to one replica, serve/replica_plane); when present it
must be a non-empty string — validated strictly, echoed on the response
line. ``deadline_s`` is an OPTIONAL wall-clock budget from submission;
when present it must be a positive finite number — validated strictly,
echoed on the response line — and an expired request completes with the
honest ``timeout`` reason (partial output attached), never silent loss.
Response lines carry the request id, the generated ids/text, and the
finish reason (``eos | length | overflow | rejected | timeout | failed``
— the last two from deadlines and the fleet's retry budget)::

    {"id": "r1", "text": "...", "tokens": [...], "reason": "eos",
     "prompt_len": 5, "n_generated": 12, "queue_ticks": 1,
     "ttft_ticks": 1, "decode_ticks": 11}

Timing columns come from the engine's always-on tick-domain request
clocks (serve/metrics.RequestTimes): ``queue_ticks`` on every terminal
status — including ``timeout``/``failed``/``overflow``, and including
queue-side deaths stamped by the fleet that never reached an engine —
``ttft_ticks``/``decode_ticks`` once a first token existed, and wall
``ttft_ms`` when the request was served with the metrics plane armed
(ServeConfig.metrics / --serve_metrics).

The JAX package's live socket mode (``run_serve --listen``) rides the
same validation through :func:`parse_request_obj`; the port's waits for
ROADMAP Queue 1 item 12(e).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from distributed_lion_tpu_torch.serve.engine import Completion, Request


def parse_request_obj(d: dict, where: str, tokenizer=None,
                      default_id=None) -> Tuple[Request, int]:
    """One request object (a parsed JSONL line or a live socket frame) →
    ``(Request, arrival_tick)`` under the strict serve/api schema. The
    ONE validation site for both transports — a field the offline mode
    refuses must refuse identically over the wire (``where`` names the
    source for the error message: ``"reqs.jsonl:7"`` or
    ``"client 127.0.0.1:52710"``)."""
    rid = d.get("id", default_id)
    if rid is None:
        raise ValueError(f"{where}: request needs an 'id'")
    if "tokens" in d:
        toks = [int(t) for t in d["tokens"]]
    elif "prompt" in d and tokenizer is not None:
        toks = tokenizer.encode(d["prompt"], add_bos=False) or [0]
    else:
        raise ValueError(
            f"{where}: request needs 'tokens' or 'prompt' "
            "(with a tokenizer)")
    group = d.get("prefix_group")
    if group is not None and (
            not isinstance(group, str) or not group):
        # strict: a mistyped tag must fail loudly, not silently
        # ride as accounting noise (same discipline as every
        # other artifact field — scripts/validate_metrics.py)
        raise ValueError(
            f"{where}: 'prefix_group' must be a non-empty "
            f"string when present, got {group!r}")
    deadline = d.get("deadline_s")
    if deadline is not None and (
            isinstance(deadline, bool)
            or not isinstance(deadline, (int, float))
            or not deadline > 0 or deadline != deadline
            or deadline == float("inf")):
        # strict: a malformed deadline must refuse, not silently
        # serve without one (a request that LOOKS bounded but
        # isn't is the worst failure mode a deadline can have)
        raise ValueError(
            f"{where}: 'deadline_s' must be a positive finite "
            f"number when present, got {deadline!r}")
    req = Request(
        req_id=rid, tokens=list(toks),
        max_new_tokens=d.get("max_new_tokens"),
        seed=int(d.get("seed", 0)), prefix_group=group,
        deadline_s=(float(deadline) if deadline is not None else None))
    return req, int(d.get("arrival_tick", 0))


def load_request_file(path: str, tokenizer=None
                      ) -> Tuple[List[Request], Dict[Any, int]]:
    """Parse a request JSONL into engine requests + arrival schedule.
    Raises on a request with neither ``tokens`` nor (``prompt`` + a
    tokenizer) — a silently-dropped request must not look served."""
    requests: List[Request] = []
    arrivals: Dict[Any, int] = {}
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            req, at = parse_request_obj(d, f"{path}:{i}", tokenizer,
                                        default_id=f"req{i}")
            requests.append(req)
            arrivals[req.req_id] = at
    return requests, arrivals


def completion_record(c: Completion, tokenizer=None) -> dict:
    rec = {"id": c.req_id, "tokens": list(c.tokens), "reason": c.reason,
           "prompt_len": c.prompt_len, "n_generated": len(c.tokens)}
    if c.timing:
        # request-lifecycle clocks (serve/metrics.RequestTimes — stamped
        # by the engine, or by the fleet for queue-side deaths):
        # queue_ticks on EVERY terminal status, ttft_ticks/decode_ticks
        # once a first token existed, wall ttft_ms when the metrics
        # plane was armed. Validated strictly by validate_metrics.py's
        # responses schema, same discipline as prefix_group.
        for k in ("ttft_ticks", "queue_ticks", "decode_ticks"):
            if k in c.timing:
                rec[k] = int(c.timing[k])
        if "ttft_ms" in c.timing:
            rec["ttft_ms"] = float(c.timing["ttft_ms"])
    if tokenizer is not None:
        rec["text"] = tokenizer.decode([int(t) for t in c.tokens])
    return rec


def handle_requests(engine, requests: List[Request],
                    arrivals: Optional[Dict[Any, int]] = None,
                    tokenizer=None) -> List[dict]:
    """Drive an engine (anything with ``run(requests, arrivals)``) over a
    workload;
    response records in request order (an unserved id would be loudly
    missing, not silently skipped). Requests tagged with ``prefix_group``
    / ``deadline_s`` get them echoed on the record."""
    done = engine.run(requests, arrivals or {})
    records = []
    for r in requests:
        rec = completion_record(done[r.req_id], tokenizer)
        if r.prefix_group is not None:
            rec["prefix_group"] = r.prefix_group
        if r.deadline_s is not None:
            rec["deadline_s"] = r.deadline_s
        records.append(rec)
    return records


def serve_request_file(engine, in_path: str, out_path: str,
                       tokenizer=None) -> List[dict]:
    requests, arrivals = load_request_file(in_path, tokenizer)
    records = handle_requests(engine, requests, arrivals, tokenizer)
    with open(out_path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, allow_nan=False) + "\n")
    return records
