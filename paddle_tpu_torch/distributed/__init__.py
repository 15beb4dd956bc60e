"""The port's host transport: the wire framing the serving front end
speaks (rpc.py).  The parameter-server RPC waits (ROADMAP.md queue 1,
item 12)."""
