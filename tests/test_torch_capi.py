"""The port's C ABI (ngt_tpu_torch/csrc/ngt_tpu_torch_capi.c, built by
``ngt_tpu_torch.native.build_capi``) on the CPU
(``NGT_TPU_TORCH_DEVICE=cpu``):

* tests/test_capi.py's own C program, which drives the whole surface
  (properties, the four insert entry points and both batch ones, build,
  every search form, object space, edges, refine, save/open, remove,
  the optimizer, the edge-count optimization, errors and the NGTQG
  calls), linked against the port's library: it prints "C API OK";
* a small C program of fixed rows that prints its search, linear-search
  and qg ids and distances (%.4f), linked once against each package's
  library: the two outputs are equal, line for line;
* an unknown device name fails the first call with an error.

The JAX package's library is built here from its own source and compiler
line into build/ngt_tpu_torch/ (git-ignored), so this file never writes
the library tests/test_capi.py builds.
"""

import os
import subprocess

import pytest
import ref_native_build  # noqa: F401  (builds the reference's library under a lock)
from test_capi import C_TEST

from ngt_tpu_torch import native as TN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CAPI = os.path.join(REPO, "ngt_tpu", "native", "src", "ngt_tpu_capi.c")

#: create an index of 300 pseudo-random rows (an LCG), build it, then for 6
#: queries print the search (epsilon 0.1) and the linear search and, after
#: saving and quantizing, 3 qg searches: id and distance lines.  Compiled
#: as C++ like the libraries, so the structs carry the C API's own names
#: (they are part of the mangled symbols)
SMALL_C = r"""
#include <stdbool.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
typedef void *H;
typedef struct { uint32_t id; float distance; } OD;
typedef struct { float *query; size_t size; float epsilon; float result_expansion; float radius; } NGTQGQuery;
typedef struct { float dimension_of_subvector; size_t max_number_of_edges; } NGTQGQuantizationParameters;
extern H ngt_create_error_object(void);
extern const char *ngt_get_error_string(const H);
extern H ngt_create_property(H);
extern bool ngt_set_property_dimension(H, int32_t, H);
extern bool ngt_set_property_edge_size_for_creation(H, int16_t, H);
extern H ngt_create_graph_and_tree(const char *, H, H);
extern bool ngt_batch_append_index(H, float *, uint32_t, H);
extern bool ngt_create_index(H, uint32_t, H);
extern bool ngt_save_index(H, const char *, H);
extern void ngt_close_index(H);
extern H ngt_create_empty_results(H);
extern uint32_t ngt_get_result_size(H, H);
extern OD ngt_get_result(const H, uint32_t, H);
extern bool ngt_search_index_as_float(H, float *, int32_t, size_t, float, float, H, H);
extern bool ngt_linear_search_index_as_float(H, float *, int32_t, size_t, H, H);
extern void ngtqg_initialize_quantization_parameters(NGTQGQuantizationParameters *);
extern bool ngtqg_quantize(const char *, NGTQGQuantizationParameters, H);
extern H ngtqg_open_index(const char *, H);
extern void ngtqg_initialize_query(NGTQGQuery *);
extern bool ngtqg_search_index(H, NGTQGQuery, H, H);
#define DIM 12
#define N 300
static uint32_t st = 12345u;
static float rnd(void) { st = st * 1664525u + 1013904223u; return (float)(st >> 8) / 16777216.0f - 0.5f; }
static void dump(const char *what, int q, H res, H err) {
  for (uint32_t i = 0; i < ngt_get_result_size(res, err); ++i) {
    OD r = ngt_get_result(res, i, err);
    printf("%s %d %u %.4f\n", what, q, r.id, r.distance);
  }
}
int main(int argc, char **argv) {
  H err = ngt_create_error_object();
  H prop = ngt_create_property(err);
  ngt_set_property_dimension(prop, DIM, err);
  ngt_set_property_edge_size_for_creation(prop, 10, err);
  H idx = ngt_create_graph_and_tree(argv[1], prop, err);
  if (!idx) { fprintf(stderr, "create: %s\n", ngt_get_error_string(err)); return 1; }
  static float rows[N * DIM];
  for (int i = 0; i < N * DIM; ++i) rows[i] = rnd();
  if (!ngt_batch_append_index(idx, rows, N, err) || !ngt_create_index(idx, 4, err)) {
    fprintf(stderr, "build: %s\n", ngt_get_error_string(err)); return 1;
  }
  H res = ngt_create_empty_results(err);
  float q[DIM];
  for (int k = 0; k < 6; ++k) {
    for (int d = 0; d < DIM; ++d) q[d] = rnd();
    if (!ngt_search_index_as_float(idx, q, DIM, 5, 0.1f, 1e30f, res, err)) return 1;
    dump("search", k, res, err);
    if (!ngt_linear_search_index_as_float(idx, q, DIM, 5, res, err)) return 1;
    dump("linear", k, res, err);
  }
  if (!ngt_save_index(idx, argv[1], err)) return 1;
  ngt_close_index(idx);
  NGTQGQuantizationParameters qp;
  ngtqg_initialize_quantization_parameters(&qp);
  if (!ngtqg_quantize(argv[1], qp, err)) { fprintf(stderr, "quantize: %s\n", ngt_get_error_string(err)); return 1; }
  H qg = ngtqg_open_index(argv[1], err);
  NGTQGQuery qq;
  ngtqg_initialize_query(&qq);
  for (int k = 0; k < 3; ++k) {
    for (int d = 0; d < DIM; ++d) q[d] = rows[(7 + 31 * k) * DIM + d];
    qq.query = q; qq.size = 5; qq.epsilon = 0.1f;
    if (!ngtqg_search_index(qg, qq, res, err)) return 1;
    dump("qg", k, res, err);
  }
  printf("SMALL OK\n");
  return 0;
}
"""


@pytest.fixture(scope="module")
def ref_lib():
    """The JAX package's C ABI, built by its own compiler line
    (ngt_tpu/native/__init__.py:140-150) into a private path."""
    out = os.path.join(REPO, "build", "ngt_tpu_torch", "ref_capi", "libngt_tpu_c.so")
    if not (os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(REF_CAPI)):
        inc, libs = TN.python_link()
        TN._build(out, REF_CAPI, ["-O2", "-shared", "-fPIC", *inc], libs)
    return out


def _run(tmp_path, source: str, lib: str, env: dict, name: str):
    """Compile `source` against `lib` and run it on a fresh index path."""
    src = tmp_path / f"{name}.c"
    src.write_text(source)
    exe = str(tmp_path / name)
    subprocess.run(["g++", "-O1", "-o", exe, str(src), lib, *TN.python_link()[1],
                    f"-Wl,-rpath,{os.path.dirname(lib)}"],
                   check=True, capture_output=True, timeout=120)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **env)
    return subprocess.run([exe, str(tmp_path / f"{name}_idx")], capture_output=True,
                          text=True, timeout=600, env=env)


def test_c_program_drives_the_port(tmp_path):
    r = _run(tmp_path, C_TEST, TN.build_capi(), {"NGT_TPU_TORCH_DEVICE": "cpu"}, "capi_test")
    assert r.returncode == 0, f"stdout={r.stdout!r} stderr={r.stderr[-3000:]!r}"
    assert "C API OK" in r.stdout


def test_both_libraries_print_equal_results(tmp_path, ref_lib):
    port = _run(tmp_path, SMALL_C, TN.build_capi(), {"NGT_TPU_TORCH_DEVICE": "cpu"}, "port")
    ref = _run(tmp_path, SMALL_C, ref_lib,
               {"NGT_TPU_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu"}, "ref")
    for r in (port, ref):
        assert r.returncode == 0, f"stdout={r.stdout[-2000:]!r} stderr={r.stderr[-3000:]!r}"
    lines = port.stdout.splitlines()
    assert lines[-1] == "SMALL OK" and len(lines) == 6 * 10 + 3 * 5 + 1
    assert lines == ref.stdout.splitlines()


def test_unknown_device_is_an_error(tmp_path):
    r = _run(tmp_path, SMALL_C, TN.build_capi(), {"NGT_TPU_TORCH_DEVICE": "tpu"}, "bad")
    assert r.returncode == 1
    assert "NGT_TPU_TORCH_DEVICE must be cpu, cuda or cuda:<n>" in r.stderr
