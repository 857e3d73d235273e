"""Serving: a streaming continuous-batching :class:`Engine` over the dense
slot cache, with pluggable schedulers and per-request sampling."""
