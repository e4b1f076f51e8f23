"""The frozen operation counts."""

import flops


def test_dips_counts_two_trunks_of_a_256_point_patch():
    assert abs(flops.DIPS_PER_PATCH - 0.674e9) / 0.674e9 < 0.002
    assert flops.dips_flops(10) == 10 * flops.DIPS_PER_PATCH


def test_filter_and_aggregation_counts():
    assert flops.FILTER_PER_ROW == 2 * (6 * 128 + 24 * 128 * 128 + 128)
    one = flops.aggregation_flops([[4]])
    assert one == 2 * 4 * 4 * 64 * 64 + 2 * 2 * 16 * 64 + 2 * 2 * 64 * 64
    assert flops.aggregation_flops([[0, 4]]) == one
    assert flops.aggregation_flops([[600]], 512) == flops.aggregation_flops([[512]], 512)


def test_feature_knn_least_time_takes_the_larger_bound():
    n = m = 100_000
    assert flops.feature_knn_least_s(n, m) == 2.0 * n * m * 64 / flops.PEAKS["tf32_flops"]
    small = flops.feature_knn_least_s(1, 10)
    assert small == ((1 + 10) * 64 * 4 + 8) / flops.PEAKS["hbm_bytes_per_s"]
