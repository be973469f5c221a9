/*
 * Standalone C host exercising the port's native embedding C API
 * (lightgbm_tpu_torch/native/include/lightgbm_tpu_c_api.h, the library
 * lightgbm_tpu_torch.native.capi.build_capi builds) the way the
 * reference's C API test drives lib_lightgbm
 * (reference: tests/c_api_test/test_.py) — dataset from a C matrix,
 * train, eval, predict, model round-trip — but from a pure C program
 * with no Python on the stack.
 *
 * The calls are tests/native_capi_driver.c's; the device is the first
 * argument ("cuda" or "cpu"), appended as device=<d> to every
 * parameter string, and the reloaded booster is reset to it (a loaded
 * model takes its device through LGBM_BoosterResetParameter).
 *
 * Usage: torch_native_capi_driver DEVICE [SYS_PATH]
 * Exits 0 and prints "NATIVE_CAPI_OK" on success.
 */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#include "lightgbm_tpu_c_api.h"

#define CHECK(call)                                                  \
  do {                                                               \
    if ((call) != 0) {                                               \
      fprintf(stderr, "FAILED %s: %s\n", #call, LGBM_GetLastError()); \
      FAIL(1);                                                      \
    }                                                                \
  } while (0)

/* verdicts leave through _exit (see the embedding caveat in
 * lightgbm_tpu_torch/native/README.md: the embedded CPython with
 * torch's and CUDA's threads makes glibc DSO-destructor order hostile
 * after main returns) */
#define FAIL(code) do { fflush(NULL); _exit(code); } while (0)

static const char* g_device = "cuda";

/* "<params> device=<g_device>" in a buffer of its own (never freed:
 * the host leaves through _exit) */
static const char* with_device(const char* params) {
  size_t len = strlen(params) + strlen(g_device) + 9;
  char* out = (char*)malloc(len);
  snprintf(out, len, "%s%sdevice=%s", params, *params ? " " : "", g_device);
  return out;
}

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s DEVICE [SYS_PATH]\n", argv[0]);
    FAIL(2);
  }
  g_device = argv[1];
  if (argc > 2) LTPU_AddSysPath(argv[2]);
  CHECK(LTPU_EnsureInitialized());

  /* synthetic binary task: y = x0 + x1 > 0, 400 rows x 4 features */
  const int n = 400, f = 4;
  double* X = (double*)malloc(sizeof(double) * n * f);
  float* y = (float*)malloc(sizeof(float) * n);
  unsigned s = 123456789u;
  for (int i = 0; i < n; ++i) {
    double row_sum = 0.0;
    for (int j = 0; j < f; ++j) {
      s = s * 1103515245u + 12345u;
      double v = ((double)(s >> 16) / 32768.0) - 1.0; /* [-1, 1) */
      X[i * f + j] = v;
      if (j < 2) row_sum += v;
    }
    y[i] = row_sum > 0.0 ? 1.0f : 0.0f;
  }

  DatasetHandle ds = NULL;
  CHECK(LGBM_DatasetCreateFromMat(X, C_API_DTYPE_FLOAT64, n, f, 1,
                                  with_device("max_bin=31 verbose=-1"), NULL,
                                  &ds));
  CHECK(LGBM_DatasetSetField(ds, "label", y, n, C_API_DTYPE_FLOAT32));

  int32_t num_data = 0, num_feat = 0;
  CHECK(LGBM_DatasetGetNumData(ds, &num_data));
  CHECK(LGBM_DatasetGetNumFeature(ds, &num_feat));
  if (num_data != n || num_feat != f) {
    fprintf(stderr, "dataset dims wrong: %d x %d\n", num_data, num_feat);
    FAIL(1);
  }

  BoosterHandle bst = NULL;
  CHECK(LGBM_BoosterCreate(
      ds,
      with_device("objective=binary num_leaves=15 min_data_in_leaf=5 "
                  "learning_rate=0.2 verbose=-1 metric=binary_logloss"),
      &bst));
  for (int it = 0; it < 20; ++it) {
    int fin = 0;
    CHECK(LGBM_BoosterUpdateOneIter(bst, &fin));
  }
  int iter = 0;
  CHECK(LGBM_BoosterGetCurrentIteration(bst, &iter));
  if (iter != 20) {
    fprintf(stderr, "iteration count wrong: %d\n", iter);
    FAIL(1);
  }

  int eval_count = 0;
  CHECK(LGBM_BoosterGetEvalCounts(bst, &eval_count));
  if (eval_count < 1) {
    fprintf(stderr, "eval count wrong: %d\n", eval_count);
    FAIL(1);
  }
  double* evals = (double*)malloc(sizeof(double) * eval_count);
  int eval_len = 0;
  CHECK(LGBM_BoosterGetEval(bst, 0, &eval_len, evals));
  if (eval_len < 1 || !(evals[0] < 0.5)) {
    fprintf(stderr, "train logloss did not improve: n=%d v=%f\n", eval_len,
            eval_len > 0 ? evals[0] : -1.0);
    FAIL(1);
  }

  int64_t pred_len = 0;
  double* preds = (double*)malloc(sizeof(double) * n);
  CHECK(LGBM_BoosterPredictForMat(bst, X, C_API_DTYPE_FLOAT64, n, f, 1,
                                  C_API_PREDICT_NORMAL, -1, "", &pred_len,
                                  preds));
  if (pred_len != n) {
    fprintf(stderr, "pred_len wrong: %lld\n", (long long)pred_len);
    FAIL(1);
  }
  int correct = 0;
  for (int i = 0; i < n; ++i) {
    if (!(preds[i] >= 0.0 && preds[i] <= 1.0) || isnan(preds[i])) {
      fprintf(stderr, "pred out of range at %d: %f\n", i, preds[i]);
      FAIL(1);
    }
    if ((preds[i] > 0.5) == (y[i] > 0.5f)) ++correct;
  }
  if (correct < (int)(0.9 * n)) {
    fprintf(stderr, "train accuracy too low: %d/%d\n", correct, n);
    FAIL(1);
  }

  /* model string round-trip: save, reload, predictions must match */
  int64_t str_len = 0;
  CHECK(LGBM_BoosterSaveModelToString(bst, -1, 0, &str_len, NULL));
  char* model = (char*)malloc((size_t)str_len);
  CHECK(LGBM_BoosterSaveModelToString(bst, -1, str_len, &str_len, model));
  BoosterHandle bst2 = NULL;
  int loaded_iters = 0;
  CHECK(LGBM_BoosterLoadModelFromString(model, &loaded_iters, &bst2));
  CHECK(LGBM_BoosterResetParameter(bst2, with_device("")));
  double* preds2 = (double*)malloc(sizeof(double) * n);
  CHECK(LGBM_BoosterPredictForMat(bst2, X, C_API_DTYPE_FLOAT64, n, f, 1,
                                  C_API_PREDICT_NORMAL, -1, "", &pred_len,
                                  preds2));
  for (int i = 0; i < n; ++i) {
    if (fabs(preds[i] - preds2[i]) > 1e-6) {
      fprintf(stderr, "round-trip mismatch at %d: %f vs %f\n", i, preds[i],
              preds2[i]);
      FAIL(1);
    }
  }

  /* feature importance: the two informative features should lead */
  double imp[4];
  CHECK(LGBM_BoosterFeatureImportance(bst, -1, 0, imp));
  if (imp[0] + imp[1] <= imp[2] + imp[3]) {
    fprintf(stderr, "importance order wrong: %f %f %f %f\n", imp[0], imp[1],
            imp[2], imp[3]);
    FAIL(1);
  }

  CHECK(LGBM_BoosterFree(bst2));
  CHECK(LGBM_BoosterFree(bst));
  CHECK(LGBM_DatasetFree(ds));
  free(evals);
  free(preds2);
  free(model);
  free(preds);
  free(X);
  free(y);
  printf("NATIVE_CAPI_OK\n");
  FAIL(0);
}
