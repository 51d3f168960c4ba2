""".g2o format reader/writer tests: parse semantics (FIX, PARAMS pre-pass,
unknown tags, auto-created vertices), round-trips, and dataset loading."""
import io
import numpy as np
import pytest

from openslam_g2o_tpu.core.graph import Graph
from openslam_g2o_tpu.io.g2o_format import load_g2o, loads_g2o, save_g2o


SAMPLE = """
# a comment line
VERTEX_SE2 0 0.1 0.2 0.3
VERTEX_SE2 1 1.0 0.0 0.0
VERTEX_XY 5 2.5 -1.5
FIX 0
EDGE_SE2 0 1 0.9 0.05 -0.1 500 0 0 500 0 5000
EDGE_SE2_XY 1 5 1.5 -1.5 1000 0 1000
"""


class TestParse:
    def test_basic(self):
        g = loads_g2o(SAMPLE)
        assert g.num_vertices() == 3
        assert g.num_edges() == 2
        assert g.vertices[0].fixed and not g.vertices[1].fixed
        np.testing.assert_allclose(g.vertices[5].params, [2.5, -1.5])
        e = g.edges[0]
        np.testing.assert_allclose(e.measurement, [0.9, 0.05, -0.1])
        np.testing.assert_allclose(
            e.information, [[500, 0, 0], [0, 500, 0], [0, 0, 5000]])

    def test_information_upper_triangle_symmetrized(self):
        g = loads_g2o("VERTEX_SE2 0 0 0 0\nVERTEX_SE2 1 0 0 0\n"
                      "EDGE_SE2 0 1 0 0 0 1 2 3 4 5 6\n")
        info = g.edges[0].information
        np.testing.assert_allclose(info, [[1, 2, 3], [2, 4, 5], [3, 5, 6]])

    def test_auto_create_missing_vertices(self):
        g = loads_g2o("VERTEX_SE2 0 1 2 3\nEDGE_SE2 0 7 0 0 0 1 0 0 1 0 1\n")
        assert 7 in g.vertices
        np.testing.assert_allclose(g.vertices[7].params, [0, 0, 0])

    def test_unknown_tags_skipped(self):
        g = loads_g2o("VERTEX_SE2 0 0 0 0\nSOME_UNKNOWN_TAG 1 2 3\n")
        assert g.num_vertices() == 1

    def test_params_prepass(self):
        # PARAMS after the edge that references it must still resolve
        text = ("VERTEX_SE2 0 0 0 0\nVERTEX_XY 1 1 1\n"
                "EDGE_SE2_POINTXY_OFFSET 0 1 0 1.0 1.0 1 0 1\n"
                "PARAMS_SE2OFFSET 0 0.2 0.0 0.0\n")
        g = loads_g2o(text)
        assert 0 in g.parameters
        assert g.edges[0].param_ids == (0,)

    def test_se3_quat(self):
        text = ("VERTEX_SE3:QUAT 0 1 2 3 0 0 0 1\n"
                "VERTEX_SE3:QUAT 1 2 2 3 0 0 0.7071067811 0.7071067811\n"
                "EDGE_SE3:QUAT 0 1 1 0 0 0 0 0.7071067811 0.7071067811 "
                + " ".join(["1" if i in (0, 6, 11, 15, 18, 20) else "0"
                           for i in range(21)]) + "\n")
        g = loads_g2o(text)
        assert g.num_vertices() == 2
        e = g.edges[0]
        assert e.measurement.shape == (7,)
        assert e.information.shape == (6, 6)
        np.testing.assert_allclose(e.information, np.eye(6))


class TestRoundTrip:
    def test_save_load_identical(self):
        g = loads_g2o(SAMPLE)
        text = save_g2o(g)
        g2 = loads_g2o(text)
        assert g2.num_vertices() == g.num_vertices()
        assert g2.num_edges() == g.num_edges()
        for vid in g.vertices:
            np.testing.assert_allclose(g2.vertices[vid].params,
                                       g.vertices[vid].params, atol=1e-15)
            assert g2.vertices[vid].fixed == g.vertices[vid].fixed
        for e1, e2 in zip(g.edges, g2.edges):
            np.testing.assert_allclose(e2.measurement, e1.measurement, atol=1e-15)
            np.testing.assert_allclose(e2.information, e1.information, atol=1e-15)


def _round_trip(g, tmp_path, name):
    """Save a generated graph as .g2o and read it back (the dataset path:
    native tokenizer where it builds, Python parser otherwise)."""
    path = tmp_path / name
    save_g2o(g, str(path))
    return load_g2o(str(path))


class TestDatasets:
    """Dataset-sized files from the in-repo generators, through the .g2o
    writer and reader."""

    def test_load_manhattan(self, tmp_path):
        from openslam_g2o_tpu.apps.simulator import Simulator2D
        src, _ = Simulator2D(seed=0).simulate(3500, landmark_obs=False)
        g = _round_trip(src, tmp_path, "manhattan.g2o")
        assert g.num_vertices() == 3500
        assert g.num_edges() == src.num_edges() > 3500
        assert all(v.vtype.name == "se2" for v in g.vertices.values())
        assert g.vertices[0].fixed

    def test_load_intel(self, tmp_path):
        from openslam_g2o_tpu.apps.simulator import Simulator2D
        src, _ = Simulator2D(seed=1).simulate(943, landmark_obs=False)
        g = _round_trip(src, tmp_path, "intel.g2o")
        assert g.num_vertices() == 943
        assert g.num_edges() >= g.num_vertices() - 1
        for vid in (1, 500, 942):
            np.testing.assert_array_equal(g.vertices[vid].params,
                                          src.vertices[vid].params)

    def test_load_sphere(self, tmp_path):
        from openslam_g2o_tpu.apps.simulator import create_sphere
        src, _ = create_sphere(n_laps=44, n_per_lap=50)
        g = _round_trip(src, tmp_path, "sphere.g2o")
        assert g.num_vertices() == 2200
        assert g.num_edges() == src.num_edges()
        assert all(v.vtype.name == "se3" for v in g.vertices.values())
        # quaternions normalized
        q = np.stack([v.params[3:7] for v in g.vertices.values()])
        np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)

    def test_load_garage(self, tmp_path):
        from openslam_g2o_tpu.apps.simulator import Simulator3D
        src, _ = Simulator3D(seed=0).simulate(1661, landmark_obs=False)
        g = _round_trip(src, tmp_path, "garage.g2o")
        assert g.num_vertices() == 1661
