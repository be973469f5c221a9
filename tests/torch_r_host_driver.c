/* C host that EXECUTES the R .Call shim (lightgbm_R.cpp) end-to-end
 * against the port's liblgbm_tpu_torch.so, with R itself replaced by the rstub
 * implementation (R-package/src/rstub) — every shim line runs for
 * real: dataset from a column-major matrix, label field, booster
 * training, prediction, model save + reload, reload-predict parity.
 * Mirrors R-package/demo/binary.R (and the reference's R test flow
 * over src/lightgbm_R.cpp).
 *
 * The calls are tests/r_host_driver.c's; the device is the first
 * argument ("cuda" or "cpu"), appended as device=<d> to every
 * parameter string, and every loaded booster is reset to it.
 * Usage: torch_r_host_driver DEVICE MODEL_PATH */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <unistd.h>

/* all verdicts leave through _exit: the embedded CPython with torch's
 * and CUDA's threads makes glibc DSO-destructor order hostile after main returns
 * (observed ~1-in-3 post-main SIGSEGV once a second booster existed),
 * and a teardown crash would mask the diagnostic exit code */
#define FINISH(code) do { fflush(NULL); _exit(code); } while (0)

#include "Rinternals.h"

/* the .Call surface exported by lightgbm_R.cpp (unmangled C names —
 * this file may be compiled as C or C++) */
#ifdef __cplusplus
extern "C" {
#endif
extern SEXP LGBM_R_DatasetCreateFromMat(SEXP, SEXP, SEXP, SEXP, SEXP);
extern SEXP LGBM_R_DatasetSetField(SEXP, SEXP, SEXP);
extern SEXP LGBM_R_DatasetFree(SEXP);
extern SEXP LGBM_R_BoosterCreate(SEXP, SEXP);
extern SEXP LGBM_R_BoosterCreateFromModelfile(SEXP);
extern SEXP LGBM_R_BoosterUpdateOneIter(SEXP);
extern SEXP LGBM_R_BoosterSaveModel(SEXP, SEXP, SEXP);
extern SEXP LGBM_R_BoosterPredictForMat(SEXP, SEXP, SEXP, SEXP, SEXP,
                                        SEXP);
extern SEXP LGBM_R_BoosterFree(SEXP);
extern SEXP LGBM_R_BoosterAddValidData(SEXP, SEXP);
extern SEXP LGBM_R_BoosterGetEval(SEXP, SEXP);
extern SEXP LGBM_R_BoosterSaveModelToString(SEXP, SEXP);
extern SEXP LGBM_R_BoosterLoadModelFromString(SEXP);
extern SEXP LGBM_R_DatasetGetField(SEXP, SEXP);
extern SEXP LGBM_R_DatasetGetNumData(SEXP);
extern SEXP LGBM_R_DatasetGetNumFeature(SEXP);
extern SEXP LGBM_R_DatasetSaveBinary(SEXP, SEXP);
extern SEXP LGBM_R_DatasetGetSubset(SEXP, SEXP, SEXP);
extern SEXP LGBM_R_DatasetSetFeatureNames(SEXP, SEXP);
extern SEXP LGBM_R_DatasetCreateFromFile(SEXP, SEXP, SEXP);
extern SEXP LGBM_R_BoosterResetParameter(SEXP, SEXP);
#ifdef __cplusplus
}
#endif

static unsigned long rng_state = 12345;
static double frand(void) { /* xorshift, deterministic across runs */
  rng_state ^= rng_state << 13;
  rng_state ^= rng_state >> 7;
  rng_state ^= rng_state << 17;
  return (double)(rng_state % 1000000ul) / 1000000.0 - 0.5;
}

static const char* g_device = "cuda";

/* "<params> device=<g_device>" as an R string */
static SEXP with_device(const char* params) {
  char buf[512];
  snprintf(buf, sizeof(buf), "%s%sdevice=%s", params, *params ? " " : "",
           g_device);
  return RStub_MakeString(buf);
}

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s DEVICE MODEL_PATH\n", argv[0]);
    FINISH(2);
  }
  g_device = argv[1];
  const char* model_path = argv[2];
  const int n = 600, f = 5;
  /* column-major matrix, as R lays out numeric matrices */
  double* mat = (double*)malloc(sizeof(double) * n * f);
  double* label = (double*)malloc(sizeof(double) * n);
  for (int i = 0; i < n; ++i) {
    double x0 = 0, x1 = 0;
    for (int j = 0; j < f; ++j) {
      double v = frand();
      mat[j * n + i] = v;
      if (j == 0) x0 = v;
      if (j == 1) x1 = v;
    }
    label[i] = (x0 - 0.7 * x1 > 0.0) ? 1.0 : 0.0;
  }

  SEXP s_mat = RStub_MakeReal(mat, (long)n * f);
  SEXP ds = LGBM_R_DatasetCreateFromMat(
      s_mat, RStub_MakeInt(n), RStub_MakeInt(f),
      with_device("objective=binary verbose=-1 num_leaves=15 "
                       "min_data_in_leaf=5"), R_NilValue);
  LGBM_R_DatasetSetField(ds, RStub_MakeString("label"),
                         RStub_MakeReal(label, n));
  /* held-out valid set for the lgb.train valids/early-stopping path */
  const int nv = 200;
  double* vmat = (double*)malloc(sizeof(double) * nv * f);
  double* vlabel = (double*)malloc(sizeof(double) * nv);
  for (int i = 0; i < nv; ++i) {
    double x0 = 0, x1 = 0;
    for (int j = 0; j < f; ++j) {
      double v = frand();
      vmat[j * nv + i] = v;
      if (j == 0) x0 = v;
      if (j == 1) x1 = v;
    }
    vlabel[i] = (x0 - 0.7 * x1 > 0.0) ? 1.0 : 0.0;
  }
  SEXP s_vmat = RStub_MakeReal(vmat, (long)nv * f);
  SEXP dv = LGBM_R_DatasetCreateFromMat(
      s_vmat, RStub_MakeInt(nv), RStub_MakeInt(f),
      with_device("objective=binary verbose=-1 num_leaves=15 "
                       "min_data_in_leaf=5"), ds /* mapper-aligned */);
  LGBM_R_DatasetSetField(dv, RStub_MakeString("label"),
                         RStub_MakeReal(vlabel, nv));

  SEXP bst = LGBM_R_BoosterCreate(
      ds, with_device("objective=binary verbose=-1 num_leaves=15 "
                           "min_data_in_leaf=5 metric=binary_logloss"));
  LGBM_R_BoosterAddValidData(bst, dv);
  double first_eval = -1.0, last_eval = -1.0;
  for (int it = 0; it < 20; ++it) {
    LGBM_R_BoosterUpdateOneIter(bst);
    SEXP ev = LGBM_R_BoosterGetEval(bst, RStub_MakeInt(1));
    if (Rf_length(ev) < 1) {
      fprintf(stderr, "empty eval at iter %d\n", it);
      FINISH(7);
    }
    last_eval = REAL(ev)[0];
    if (it == 0) first_eval = last_eval;
  }
  if (!(last_eval < first_eval)) {
    fprintf(stderr, "valid logloss did not fall: %g -> %g\n",
            first_eval, last_eval);
    FINISH(8);
  }
  SEXP pred = LGBM_R_BoosterPredictForMat(
      bst, s_mat, RStub_MakeInt(n), RStub_MakeInt(f), RStub_MakeInt(0),
      RStub_MakeInt(-1));
  if (Rf_length(pred) != n) {
    fprintf(stderr, "bad prediction length %d\n", Rf_length(pred));
    FINISH(4);
  }
  int correct = 0;
  for (int i = 0; i < n; ++i)
    correct += ((REAL(pred)[i] > 0.5) == (label[i] > 0.5));
  double acc = (double)correct / n;

  LGBM_R_BoosterSaveModel(bst, RStub_MakeInt(-1),
                          RStub_MakeString(model_path));
  SEXP bst2 = LGBM_R_BoosterCreateFromModelfile(RStub_MakeString(model_path));
  LGBM_R_BoosterResetParameter(bst2, with_device(""));
  SEXP pred2 = LGBM_R_BoosterPredictForMat(
      bst2, s_mat, RStub_MakeInt(n), RStub_MakeInt(f), RStub_MakeInt(0),
      RStub_MakeInt(-1));
  double maxdiff = 0.0;
  for (int i = 0; i < n; ++i) {
    double d = fabs(REAL(pred)[i] - REAL(pred2)[i]);
    if (d > maxdiff) maxdiff = d;
  }
  /* SHAP contributions (lgb.interprete's predict path): per-row
   * feature contributions + bias must sum to the raw score */
  SEXP raw = LGBM_R_BoosterPredictForMat(
      bst, s_mat, RStub_MakeInt(n), RStub_MakeInt(f), RStub_MakeInt(1),
      RStub_MakeInt(-1));
  SEXP contrib = LGBM_R_BoosterPredictForMat(
      bst, s_mat, RStub_MakeInt(n), RStub_MakeInt(f), RStub_MakeInt(3),
      RStub_MakeInt(-1));
  if (Rf_length(contrib) != (long)n * (f + 1)) {
    fprintf(stderr, "bad contrib length %d\n", Rf_length(contrib));
    FINISH(9);
  }
  double worst_gap = 0.0;
  for (int i = 0; i < n; ++i) {
    double s_sum = 0.0;
    for (int j = 0; j <= f; ++j) s_sum += REAL(contrib)[i * (f + 1) + j];
    double gap = fabs(s_sum - REAL(raw)[i]);
    if (gap > worst_gap) worst_gap = gap;
  }
  if (worst_gap > 1e-4) {
    fprintf(stderr, "contribs don't sum to raw score (gap %g)\n",
            worst_gap);
    FINISH(10);
  }

  /* model-string round trip (saveRDS/readRDS.lgb.Booster payload) */
  SEXP mstr = LGBM_R_BoosterSaveModelToString(bst, RStub_MakeInt(-1));
  SEXP bst3 = LGBM_R_BoosterLoadModelFromString(mstr);
  LGBM_R_BoosterResetParameter(bst3, with_device(""));
  SEXP pred3 = LGBM_R_BoosterPredictForMat(
      bst3, s_mat, RStub_MakeInt(n), RStub_MakeInt(f), RStub_MakeInt(0),
      RStub_MakeInt(-1));
  double maxdiff3 = 0.0;
  for (int i = 0; i < n; ++i) {
    double d = fabs(REAL(pred)[i] - REAL(pred3)[i]);
    if (d > maxdiff3) maxdiff3 = d;
  }

  /* --- Dataset generics surface (lgb.Dataset.R: dim, getinfo/setinfo,
   * slice, lgb.Dataset.save.binary — round-5 R-surface tail) --- */
  if (Rf_asInteger(LGBM_R_DatasetGetNumData(ds)) != n) {
    fprintf(stderr, "GetNumData != %d\n", n);
    FINISH(12);
  }
  if (Rf_asInteger(LGBM_R_DatasetGetNumFeature(ds)) != f) {
    fprintf(stderr, "GetNumFeature != %d\n", f);
    FINISH(13);
  }
  /* setinfo/getinfo round trip on weights + label readback */
  double* w = (double*)malloc(sizeof(double) * n);
  for (int i = 0; i < n; ++i) w[i] = 1.0 + (i % 3) * 0.25;
  LGBM_R_DatasetSetField(ds, RStub_MakeString("weight"),
                         RStub_MakeReal(w, n));
  SEXP got_w = LGBM_R_DatasetGetField(ds, RStub_MakeString("weight"));
  SEXP got_l = LGBM_R_DatasetGetField(ds, RStub_MakeString("label"));
  if (Rf_length(got_w) != n || Rf_length(got_l) != n) {
    fprintf(stderr, "getinfo lengths %d/%d\n", Rf_length(got_w),
            Rf_length(got_l));
    FINISH(14);
  }
  double field_gap = 0.0;
  for (int i = 0; i < n; ++i) {
    double dw = fabs(REAL(got_w)[i] - w[i]);
    double dl = fabs(REAL(got_l)[i] - label[i]);
    if (dw > field_gap) field_gap = dw;
    if (dl > field_gap) field_gap = dl;
  }
  if (field_gap > 1e-6) {
    fprintf(stderr, "set/getinfo round trip gap %g\n", field_gap);
    FINISH(15);
  }
  /* feature names (dimnames<-) */
  LGBM_R_DatasetSetFeatureNames(
      ds, RStub_MakeString("c0\tc1\tc2\tc3\tc4"));
  /* slice: first 300 rows; a booster must train on the subset */
  double* idx = (double*)malloc(sizeof(double) * 300);
  for (int i = 0; i < 300; ++i) idx[i] = (double)i; /* 0-based */
  SEXP sub = LGBM_R_DatasetGetSubset(
      ds, RStub_MakeReal(idx, 300),
      with_device("objective=binary verbose=-1 num_leaves=15 "
                       "min_data_in_leaf=5"));
  if (Rf_asInteger(LGBM_R_DatasetGetNumData(sub)) != 300) {
    fprintf(stderr, "subset num_data != 300\n");
    FINISH(16);
  }
  /* the subset must carry the sliced metadata: its label field is the
   * parent's first 300 labels */
  SEXP sub_l = LGBM_R_DatasetGetField(sub, RStub_MakeString("label"));
  if (Rf_length(sub_l) != 300) {
    fprintf(stderr, "subset label length %d\n", Rf_length(sub_l));
    FINISH(18);
  }
  for (int i = 0; i < 300; ++i) {
    if (fabs(REAL(sub_l)[i] - label[i]) > 1e-6) {
      fprintf(stderr, "subset label mismatch at %d\n", i);
      FINISH(19);
    }
  }
  SEXP bsub = LGBM_R_BoosterCreate(
      sub, with_device("objective=binary verbose=-1 num_leaves=15 "
                            "min_data_in_leaf=5"));
  for (int it = 0; it < 3; ++it) LGBM_R_BoosterUpdateOneIter(bsub);
  /* save.binary: write + reload the binary cache as a dataset */
  char bin_path[512];
  snprintf(bin_path, sizeof bin_path, "%s.dsbin", model_path);
  LGBM_R_DatasetSaveBinary(ds, RStub_MakeString(bin_path));
  SEXP ds_bin = LGBM_R_DatasetCreateFromFile(
      RStub_MakeString(bin_path),
      with_device("objective=binary verbose=-1 num_leaves=15 "
                       "min_data_in_leaf=5"), R_NilValue);
  if (Rf_asInteger(LGBM_R_DatasetGetNumData(ds_bin)) != n) {
    fprintf(stderr, "binary-reloaded num_data != %d\n", n);
    FINISH(17);
  }
  LGBM_R_BoosterFree(bsub);
  LGBM_R_DatasetFree(sub);
  LGBM_R_DatasetFree(ds_bin);

  LGBM_R_BoosterFree(bst);
  LGBM_R_BoosterFree(bst2);
  LGBM_R_BoosterFree(bst3);
  LGBM_R_DatasetFree(ds);
  LGBM_R_DatasetFree(dv);
  printf("R-HOST OK acc=%.3f maxdiff=%g eval %g->%g contrib_gap=%g "
         "strdiff=%g field_gap=%g\n", acc, maxdiff, first_eval,
         last_eval, worst_gap, maxdiff3, field_gap);
  int rc = 0;
  if (acc < 0.85) rc = 5;
  if (maxdiff > 1e-10) rc = 6;
  if (maxdiff3 > 1e-10) rc = 11;
  FINISH(rc);
}
