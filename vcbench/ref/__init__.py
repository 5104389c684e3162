"""Frozen plain reference of the v1 converter and the real-time stream.

A copy of the port's module code as it stood when the benchmark was made,
with every CUDA kernel replaced by its plain twin (``ops/attention.py``,
``ops/anti_alias.py``). It imports nothing of the port: the benchmark holds
the port's outputs against it, and a later change to the port does not
change it.
"""
