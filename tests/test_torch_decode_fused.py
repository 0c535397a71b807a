"""The port's Parquet device-decode staging and its plain decode against
the JAX package, case by case over the decode corpus
(``chip_smoke.decode_corpus``, written with pyarrow into ``tmp_path``)
and the three tables of bench.py's q3 as the port's writer writes them
(decimal(7,2) as a 4-byte FLBA, item's string dictionary, date_dim):

- the staging (``words``, ``extras``, ``layout``) equals the JAX
  package's ``prepare_encoded_upload`` byte for byte;
- the plain decode (``columnar/transfer.py`` ``_encoded_decode_body``,
  what ``kernels/decode_fused.py`` runs for CPU tensors) equals the JAX
  ``decodeFused`` Pallas kernel in interpret mode, element for element,
  exactly (floats compared as bits).

The CUDA kernel itself is held against the same plain version on the
card by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from chip_smoke import decode_corpus, q3_tables
from spark_rapids_tpu.columnar import device as JD
from spark_rapids_tpu.columnar import transfer as JX
from spark_rapids_tpu.io import arrow_convert as JA
from spark_rapids_tpu.io import device_decode as JDD
from spark_rapids_tpu.io import readers as JR
from spark_rapids_tpu.kernels import decode_fused as JDF

from spark_rapids_tpu_torch import kernels as KR
from spark_rapids_tpu_torch.columnar import device as PD
from spark_rapids_tpu_torch.columnar import transfer as PX
from spark_rapids_tpu_torch.io import arrow_convert as PA
from spark_rapids_tpu_torch.io import device_decode as PDD
from spark_rapids_tpu_torch.io import readers as PR
from spark_rapids_tpu_torch.kernels import decode_fused as PDF

torch.set_num_threads(2)

CASES = ["plain", "dict", "page_nulls", "int_dict_overflow",
         "str_dict_overflow", "dec128_flba", "delta_nulls", "delta_length",
         "bss", "page_v2", "bool_ts", "plain_strings",
         "narrow_ints_binary", "delta_byte_array_mixed", "q1_row_group",
         "q3_store_sales", "q3_item", "q3_date_dim"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from spark_rapids_tpu_torch.interop import host_batch_from_numpy
    from spark_rapids_tpu_torch.sql import types as PT
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    root = tmp_path_factory.mktemp("corpus")
    out = decode_corpus(str(root), q1_rows=6000)
    types = {"long": PT.LongT, "int": PT.IntegerT, "str": PT.StringT,
             "dec72": PT.DecimalType(7, 2)}
    s = TorchSparkSession(device="cpu")
    for name, cols in q3_tables(4000).items():
        d = str(root / name)
        s.createDataFrame(host_batch_from_numpy(
            [(c, types[k]) for c, k, _a in cols],
            [a for _c, _k, a in cols]), num_partitions=1).write.parquet(d)
        out[f"q3_{name}"] = next(str(p) for p in sorted(
            (root / name).glob("*.parquet")))
    return out


def _schema_of(path, mod):
    import pyarrow.parquet as pq
    return mod.arrow_schema_to_sql(pq.ParquetFile(path).schema_arrow)


def _staged(path):
    """(jax staged token, port staged token) for the file's first row
    group."""
    ju = JR.plan_scan_units("parquet", [(path, {})])[0]
    pu = PR.plan_scan_units("parquet", [(path, {})])[0]
    jenc = JDD.plan_unit_encoded(ju, _schema_of(path, JA))
    penc = PDD.plan_unit_encoded(pu, _schema_of(path, PA))
    assert jenc is not None and penc is not None
    assert penc.fallbacks == jenc.fallbacks
    cap = PD.bucket_capacity(penc.num_rows)
    assert cap == JD.bucket_capacity(jenc.num_rows)
    return JX.prepare_encoded_upload(jenc, cap), \
        PX.prepare_encoded_upload(penc, cap)


def _same_array(a: np.ndarray, b: np.ndarray, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("case", CASES)
def test_staging_is_byte_identical(corpus, case):
    jt, pt = _staged(corpus[case])
    _tag, _s, jn, jcap, jwords, jextras, jlayout, _spec, _fuse = jt
    _tag, _s, pn, pcap, pwords, pextras, playout, _spec = pt
    assert (pn, pcap) == (jn, jcap)
    assert playout == jlayout
    _same_array(jwords, pwords, "words")
    assert len(pextras) == len(jextras)
    for i, (a, b) in enumerate(zip(jextras, pextras)):
        _same_array(a, b, f"extras[{i}]")


@pytest.mark.parametrize("case", CASES)
def test_plain_decode_equals_jax_kernel(corpus, case):
    import jax.numpy as jnp
    jt, pt = _staged(corpus[case])
    _tag, _s, n, cap, words, extras, layout, _spec, _fuse = jt
    fn = JDF.build_fused_decode(layout, cap, interpret=True)
    jactive, jouts = fn(jnp.asarray(words), jnp.asarray(n, jnp.int64),
                        *[jnp.asarray(e) for e in extras])
    _tag, _s, pn, pcap, pwords, pextras, playout, _spec = pt
    KR.reset_launches()
    pactive, pouts = PDF.decode_fused(
        playout, pcap, pn, torch.from_numpy(pwords),
        [torch.from_numpy(np.ascontiguousarray(e)) for e in pextras])
    assert KR.LAUNCHES["decodeFused"] == 0  # CPU tensors: plain version
    _same_array(np.asarray(jactive), pactive.numpy(), "active")
    assert len(pouts) == len(jouts)
    for i, (a, b) in enumerate(zip(jouts, pouts)):
        _same_array(np.asarray(a), b.numpy(), f"{case} output {i}")


def test_corpus_covers_every_kind_and_page_class(corpus):
    """The corpus reaches every decode lane the kernel has."""
    kinds, classes = set(), set()
    for case in CASES:
        _jt, pt = _staged(corpus[case])
        layout = pt[6]
        kinds |= {ent[1] for ent in layout if ent[0] == "dev"}
        ju = PR.plan_scan_units("parquet", [(corpus[case], {})])[0]
        enc = PDD.plan_unit_encoded(ju, _schema_of(corpus[case], PA))
        for plan in enc.plans.values():
            classes |= set(plan.pg_enc)
    assert kinds == {"bool", "int", "f32", "f64", "dec64", "dec128",
                     "str"}
    assert classes == {PDD.PGE_DICT, PDD.PGE_PLAIN, PDD.PGE_DELTA,
                       PDD.PGE_BSS, PDD.PGE_PLAIN_STR, PDD.PGE_DL_STR}


def test_host_only_layout_decodes_without_a_launch(corpus, tmp_path):
    """A row group whose every column host-decodes (DELTA_BYTE_ARRAY) is
    no EncodedBatch in either package: the scan host-decodes it and no
    decode runs."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    path = str(tmp_path / "dba.parquet")
    pq.write_table(pa.table({"dba": pa.array(
        [f"prefix-common-{i}" for i in range(500)])}), path,
        use_dictionary=False, column_encoding={"dba": "DELTA_BYTE_ARRAY"})
    pu = PR.plan_scan_units("parquet", [(path, {})])[0]
    ju = JR.plan_scan_units("parquet", [(path, {})])[0]
    assert PDD.plan_unit_encoded(pu, _schema_of(path, PA)) is None
    assert JDD.plan_unit_encoded(ju, _schema_of(path, JA)) is None
    from spark_rapids_tpu_torch.sql.session import TorchSparkSession
    s = TorchSparkSession(device="cpu")
    s.read.parquet(path).createOrReplaceTempView("t")
    KR.reset_launches()
    rows = s.sql("SELECT * FROM t").collect()
    assert [r[0] for r in rows] == [f"prefix-common-{i}" for i in range(500)]
    scan = s.last_plan
    while not isinstance(scan, PR.CpuFileScanExec):
        scan = scan.children[0]
    snap = scan.metrics.snapshot()
    # the host decode's walls beside the counters
    assert snap.pop("decodeTime") > 0 and snap.pop("convertTime") > 0
    # the device planner's host wall, which found nothing to decode
    assert snap.pop("deviceDecodeTime") > 0
    assert snap == {"deviceFallbackUnits": 1}
    assert KR.LAUNCHES["decodeFused"] == 0


class _CudaTyped:
    """A CPU tensor that reports itself as lying on a CUDA device."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)

    def is_contiguous(self):
        return True


def test_kernel_raises_on_unservable_cuda_requests(corpus):
    """On a CUDA tensor the wrapper launches or raises: it never falls
    back to the plain version."""
    _jt, pt = _staged(corpus["dict"])
    _tag, _s, n, cap, words, extras, layout, _spec = pt
    cuda_extras = [_CudaTyped(torch.from_numpy(np.ascontiguousarray(e)))
                   for e in extras]
    KR.reset_launches()
    with pytest.raises(KR.KernelError, match="not CUDA"):
        PDF.decode_fused(layout, cap, n, _CudaTyped(torch.from_numpy(words)),
                         [torch.from_numpy(np.ascontiguousarray(e))
                          for e in extras])
    with pytest.raises(KR.KernelError, match="int32"):
        PDF.decode_fused(layout, cap, n, _CudaTyped(torch.from_numpy(
            words.view(np.uint32))), cuda_extras)
    with pytest.raises(KR.KernelError, match="rows at capacity"):
        PDF.decode_fused(layout, cap, cap + 1, _CudaTyped(torch.from_numpy(
            words)), cuda_extras)
    bad = list(cuda_extras)
    bad[0] = _CudaTyped(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(KR.KernelError, match="dense_start"):
        PDF.decode_fused(layout, cap, n, _CudaTyped(torch.from_numpy(
            words)), bad)
    assert KR.LAUNCHES["decodeFused"] == 0
