"""Host and device columnar batches."""
