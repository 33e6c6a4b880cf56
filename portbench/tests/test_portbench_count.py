"""The yardstick's counts against hand-worked cases."""

import pytest
import torch

import count


def test_least_seconds_takes_the_larger_bound():
    # 3.35e12 bytes take 1 s; 67e12 operations take 1 s
    assert count.least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
    assert count.least_seconds(1.0, 134e12) == pytest.approx(2.0)


def test_k2_need_counts_lanes_and_touched_bytes_once():
    # 1000 lanes: 36 B and 84 operations each, plus 4096 distinct field bytes
    assert count.k2_need(1000, 4096) == (36_000 + 4096, 84_000)


def test_k5_need_counts_the_check_of_every_lane_and_each_miss():
    # 100 lanes checked (117 B each), 3 misses (276 B each); one evaluation
    # a check and one a miss, 80 operations each
    assert count.k5_need(100, 3) == (100 * 117 + 3 * 276, 103 * 80)


def test_distinct_nodes_shares_corners_between_neighbours():
    # cells (0,0) and (0,1) of a grid 5 nodes wide share two corners: 6 nodes;
    # the same cell twice adds none
    j, i = torch.tensor([0, 0, 0]), torch.tensor([0, 1, 1])
    assert count.distinct_nodes(j, i, 5, torch) == 6
