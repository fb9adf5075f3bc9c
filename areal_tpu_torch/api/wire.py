"""HTTP header names shared by every producer and consumer of the wire
protocol (``areal_tpu/api/wire.py``): a header that one side spells
differently is silently absent on the other, so the names live here once.
Header names are case-insensitive on the wire."""

from __future__ import annotations

# cross-process trace correlation: "task=<task_id>;session=<session_id>"
TRACE_HEADER = "x-areal-trace"

# request-lifecycle deadline, absolute unix-epoch seconds
DEADLINE_HEADER = "x-areal-deadline"

# load-shedding priority class ("interactive" | "rollout")
PRIORITY_HEADER = "x-areal-priority"

# control-plane auth for POST /autopilot/knobs
AUTOPILOT_TOKEN_HEADER = "x-areal-autopilot-token"

# weight-broadcast relay tree: comma-separated downstream addresses + the
# per-hop timeout
RELAY_HEADER = "X-Areal-Relay"
RELAY_TIMEOUT_HEADER = "X-Areal-Relay-Timeout"

# gateway tier: the shard id a response came from, and the shard the
# client's own ring expected (misroute detection)
GATEWAY_SHARD_HEADER = "x-areal-gateway-shard"
GATEWAY_EXPECT_SHARD_HEADER = "x-areal-expect-shard"
