"""spark_rapids_tpu_torch: the PyTorch/CUDA port of spark_rapids_tpu.

A Spark-SQL-shaped engine whose device operators run on torch tensors,
with the JAX package's Pallas kernels replaced by CUDA kernels written
for Hopper (``csrc/``). Importing it imports nothing of the JAX package.
Entry point: ``spark_rapids_tpu_torch.sql.session.TorchSparkSession``.
"""
