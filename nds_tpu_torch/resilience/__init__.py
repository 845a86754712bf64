"""The port's resilience layer, as far as the scheduler needs it: the
retry policy and failure classes (``retry.py``), the injected-fault
classes and the query context (``faults.py``) and the query journal's
write side (``journal.py``). Port of a part of ``nds_tpu/resilience/``;
the rest (fault points, the drain, the watchdog, supervised streams,
``--resume``) waits for ROADMAP Queue 1 item 15."""
