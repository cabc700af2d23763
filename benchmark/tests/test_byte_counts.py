"""The yardstick's byte counts, from shapes."""

import pytest

from benchmark import roofline

LANES = 32768 * 52  # one 2pc-10 step: 1,703,936 successor lanes


def test_fold_reads_each_lane_once_and_writes_each_key_once():
    assert roofline.fold_bytes(LANES, 13) == LANES * 13 * 8 + LANES * 8 == 190_840_832


def test_plain_insert_matches_the_kernel_table_bound():
    # The step shape of the kernel table's bound (0.0066 ms, 21,987,168 B):
    # 443,111 active lanes, 35,619 new keys.
    assert roofline.insert_bytes(LANES, 443_111, 35_619) == 21_987_168


def test_fused_insert_adds_suspect_flags_and_summary_words():
    plain = roofline.insert_bytes(LANES, 400_000, 30_000)
    fused = roofline.insert_fused_bytes(LANES, 400_000, 30_000, hashes=4)
    assert fused - plain == LANES + 30_000 * 16


def test_roofline_share_and_peaks():
    bw = roofline.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"]
    assert bw == 3.35e12
    # 3.35 GB moved in 1 ms is the whole roofline at 3.35 TB/s
    assert roofline.roofline_pct(3_350_000_000, 1.0, bw) == pytest.approx(100.0)
    assert roofline.roofline_pct(21_987_168, 0.1356, bw) == pytest.approx(4.84, abs=0.01)
    with pytest.raises(KeyError):
        roofline.peaks("no such card")
