"""File IO of the port: the Parquet reader and writer.

The host lists files, reads footers, prunes row groups by their
statistics, reads the raw column chunks, decompresses pages and parses
page and run headers (``device_decode.py``); the pages then go to the card
still encoded and the ``decodeFused`` kernel expands them into columns
(``columnar/transfer.py``, ``kernels/decode_fused.py``). Arrow
(``pyarrow``) supplies the footers, the codecs, the host decode of the
columns the device cannot take, and the writer.
"""
