"""The port's distributed engine over ``torch.distributed`` (NCCL on the
card, gloo on the CPU): meshes, the launch helpers, the hash-partition
exchange and the SPMD executor. Port of ``nds_tpu/parallel/``."""
