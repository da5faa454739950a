"""Direct unit tests for the TAC TSV reader/writer.

``read_multi_standoff_tof_data`` previously had only
slow-marked CLI e2e coverage; a header-format regression must be caught
in the default suite.  Semantics under test mirror the reference's
``readMultiStandoffTOFdata`` (``utilities/utilities.py:198-216``): rows
of ``lowBinEdge \\t run0 \\t run1 ...``, no header line, column 0 the
lower bin edge, ``n_runs`` count columns kept.
"""
import numpy as np
import pytest

from mcmctoffitting_tpu.utils import data_io


def _write(path, lines):
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_reads_reference_format(tmp_path):
    fn = _write(tmp_path / "tac.dat", [
        "100.0\t5\t7\t9\t11",
        "101.0\t6\t8\t10\t12",
        "102.0\t0\t1\t2\t3",
    ])
    data = data_io.read_multi_standoff_tof_data(fn, 4)
    assert data.shape == (3, 5)
    np.testing.assert_array_equal(data[:, 0], [100.0, 101.0, 102.0])
    np.testing.assert_array_equal(data[1], [101.0, 6, 8, 10, 12])


def test_n_runs_selects_leading_columns(tmp_path):
    # a 4-run file read with n_runs=2 keeps only the first two run columns
    fn = _write(tmp_path / "tac.dat", ["50.0\t1\t2\t3\t4",
                                       "54.0\t5\t6\t7\t8"])
    data = data_io.read_multi_standoff_tof_data(fn, 2)
    assert data.shape == (2, 3)
    np.testing.assert_array_equal(data, [[50.0, 1, 2], [54.0, 5, 6]])


def test_blank_lines_skipped(tmp_path):
    fn = _write(tmp_path / "tac.dat", ["10.0\t1\t2", "", "  ",
                                       "11.0\t3\t4"])
    data = data_io.read_multi_standoff_tof_data(fn, 2)
    assert data.shape == (2, 3)
    np.testing.assert_array_equal(data[:, 0], [10.0, 11.0])


def test_float_counts_and_negatives(tmp_path):
    # TAC exports carry float counts; window edges can be negative-tagged
    fn = _write(tmp_path / "tac.dat", ["-5.5\t1.25\t0.0",
                                       "-4.5\t2.75\t3.5"])
    data = data_io.read_multi_standoff_tof_data(fn, 2)
    np.testing.assert_allclose(data, [[-5.5, 1.25, 0.0], [-4.5, 2.75, 3.5]])


def test_write_read_roundtrip(tmp_path):
    edges = np.arange(100.0, 110.0, 1.0)
    rng = np.random.default_rng(0)
    counts = rng.poisson(50.0, (10, 3)).astype(float)
    fn = str(tmp_path / "rt.dat")
    data_io.write_multi_standoff_tof_data(fn, edges, counts)
    data = data_io.read_multi_standoff_tof_data(fn, 3)
    np.testing.assert_array_equal(data[:, 0], edges)
    np.testing.assert_array_equal(data[:, 1:], counts)


def test_select_window_half_open(tmp_path):
    fn = _write(tmp_path / "tac.dat",
                [f"{e}\t{10 * i}\t{20 * i}" for i, e in
                 enumerate(np.arange(100.0, 106.0))])
    data = data_io.read_multi_standoff_tof_data(fn, 2)
    counts, edges = data_io.select_window(data, 1, 101.0, 104.0)
    # [lo, hi): 101, 102, 103 kept; run index 1 -> column 2
    np.testing.assert_array_equal(edges, [101.0, 102.0, 103.0])
    np.testing.assert_array_equal(counts, [20.0, 40.0, 60.0])


def test_missing_file_raises():
    with pytest.raises(OSError):
        data_io.read_multi_standoff_tof_data("/nonexistent/file.dat", 4)
