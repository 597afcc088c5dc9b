"""Process-global monitors of the port (counterpart of ``sheeprl_tpu/telemetry/``).

Only the compile accounting is ported so far (:mod:`.monitors`); the hub,
the flight recorder and the checkpoint and resilience monitors come with
the runtime services (ROADMAP.md, queue A item 6).
"""
