"""The port's resilience layer (port of ``nds_tpu/resilience/``):

- ``faults``     seeded, deterministic fault injection at named sites
                 (``NDS_TPU_FAULTS``; a no-op when unset, and never
                 inside a CUDA graph capture)
- ``retry``      transient-vs-deterministic classification and
                 ``RetryPolicy``
- ``journal``    the phase journal of the orchestrators
                 (``bench_state.json``) and the query journals of the
                 power loop, the maintenance CLI and the in-process
                 streams; ``--resume`` reads them
- ``drain``      SIGTERM/SIGINT as a drain: exit 75, resumable
- ``watchdog``   heartbeats, the hang watchdog and the heartbeat file
- ``supervise``  supervised subprocess streams (``StreamSupervisor``;
                 the serve fleet's ``ReplicaSupervisor`` comes with
                 ROADMAP Queue 1 item 9)
"""
