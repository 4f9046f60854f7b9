"""Chunked gated linear attention (RWKV6 / GLA / Mamba2-SSD): the outputs and the final state of the recurrence."""
