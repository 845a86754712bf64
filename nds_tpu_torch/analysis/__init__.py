"""Static analysis of the port's plans: the size estimate the scheduler
places queries by (``plan_verify.py``). Port of a part of
``nds_tpu/analysis/``; the verifier and the sanitizers wait for ROADMAP
Queue 1 item 8."""
