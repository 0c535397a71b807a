"""Python-worker side of the port (the port's copy of
``spark_rapids_tpu.python``): vectorized pandas UDFs and mapInPandas
evaluated in a pool of worker processes that speak Arrow IPC with the
engine. The package imports nothing, so a worker started as
``python -m spark_rapids_tpu_torch.python.worker`` loads neither torch
nor the engine."""
