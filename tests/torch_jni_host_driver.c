/* C host that EXECUTES the JNI binding (jni/lightgbm_jni.c) without a
 * JVM: fabricates a JNIEnv function table (string/array accessors,
 * exception raise) and drives the full SWIG-breadth surface through
 * the Java_* entry points against the port's liblgbm_tpu_torch.so
 * (lightgbm_tpu_torch.native.capi.build_capi) — dataset
 * create (mat/CSR/subset/reference), train, valid-set eval flow,
 * dense/CSR predict parity, model string/file round trips, custom
 * objective iteration, rollback, merge, leaf mutation, feature names,
 * file prediction.  With a JDK present the same binding builds against
 * the genuine <jni.h> and runs under a real JVM (see
 * jni/LightGBMNative.java).
 *
 * The calls are tests/jni_host_driver.c's; the device is the first
 * argument ("cuda" or "cpu"), appended as device=<d> to every
 * parameter string, and every loaded booster is reset to it.
 * Usage: torch_jni_host_driver DEVICE MODEL_PATH */
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <unistd.h>
#include <string.h>

#include "../jni/jni_min.h"

/* ---- fake object model ------------------------------------------- */
typedef struct _jobject {
  int kind; /* 0 string, 1 double[], 2 class, 3 int[], 4 float[],
               5 object[] */
  const char* str;
  double* d;
  jint* i;
  jfloat* f;
  jobject* o;
  jsize len;
} FakeObj;

static jobject mk_string(const char* s) {
  FakeObj* o = calloc(1, sizeof(FakeObj));
  o->kind = 0;
  o->str = s;
  return o;
}

static jobject mk_darray(const double* v, jsize n) {
  FakeObj* o = calloc(1, sizeof(FakeObj));
  o->kind = 1;
  o->d = malloc(sizeof(double) * (size_t)n);
  if (v) memcpy(o->d, v, sizeof(double) * (size_t)n);
  o->len = n;
  return o;
}

static jobject mk_iarray(const int* v, jsize n) {
  FakeObj* o = calloc(1, sizeof(FakeObj));
  o->kind = 3;
  o->i = malloc(sizeof(jint) * (size_t)n);
  if (v) memcpy(o->i, v, sizeof(jint) * (size_t)n);
  o->len = n;
  return o;
}

static jobject mk_farray(const float* v, jsize n) {
  FakeObj* o = calloc(1, sizeof(FakeObj));
  o->kind = 4;
  o->f = malloc(sizeof(jfloat) * (size_t)n);
  if (v) memcpy(o->f, v, sizeof(jfloat) * (size_t)n);
  o->len = n;
  return o;
}

/* ---- JNIEnv implementation --------------------------------------- */
static jclass env_FindClass(JNIEnv* env, const char* name) {
  (void)env;
  FakeObj* o = calloc(1, sizeof(FakeObj));
  o->kind = 2;
  o->str = name;
  return o;
}

static jint env_ThrowNew(JNIEnv* env, jclass cls, const char* msg) {
  (void)env;
  fprintf(stderr, "java exception %s: %s\n",
          cls ? ((FakeObj*)cls)->str : "?", msg ? msg : "");
  exit(3); /* a real JVM unwinds; the host just fails the test */
}

static const char* env_GetStringUTFChars(JNIEnv* env, jstring s,
                                         jboolean* copy) {
  (void)env;
  if (copy) *copy = 0;
  return ((FakeObj*)s)->str;
}

static void env_ReleaseStringUTFChars(JNIEnv* env, jstring s,
                                      const char* c) {
  (void)env;
  (void)s;
  (void)c;
}

static jsize env_GetArrayLength(JNIEnv* env, jarray a) {
  (void)env;
  return ((FakeObj*)a)->len;
}

static jdoubleArray env_NewDoubleArray(JNIEnv* env, jsize n) {
  (void)env;
  return mk_darray(NULL, n);
}

static jdouble* env_GetDoubleArrayElements(JNIEnv* env, jdoubleArray a,
                                           jboolean* copy) {
  (void)env;
  if (copy) *copy = 0;
  return ((FakeObj*)a)->d;
}

static void env_ReleaseDoubleArrayElements(JNIEnv* env, jdoubleArray a,
                                           jdouble* d, jint mode) {
  (void)env;
  (void)a;
  (void)d;
  (void)mode;
}

static void env_SetDoubleArrayRegion(JNIEnv* env, jdoubleArray a,
                                     jsize start, jsize n,
                                     const jdouble* src) {
  (void)env;
  memcpy(((FakeObj*)a)->d + start, src, sizeof(double) * (size_t)n);
}

static jstring env_NewStringUTF(JNIEnv* env, const char* s) {
  (void)env;
  FakeObj* o = calloc(1, sizeof(FakeObj));
  o->kind = 0;
  o->str = strdup(s ? s : "");
  return o;
}

static jobjectArray env_NewObjectArray(JNIEnv* env, jsize n, jclass cls,
                                       jobject init) {
  (void)env;
  (void)cls;
  FakeObj* o = calloc(1, sizeof(FakeObj));
  o->kind = 5;
  o->o = calloc((size_t)(n > 0 ? n : 1), sizeof(jobject));
  for (jsize k = 0; k < n; ++k) o->o[k] = init;
  o->len = n;
  return o;
}

static void env_SetObjectArrayElement(JNIEnv* env, jobjectArray a,
                                      jsize idx, jobject v) {
  (void)env;
  ((FakeObj*)a)->o[idx] = v;
}

static jobject env_GetObjectArrayElement(JNIEnv* env, jobjectArray a,
                                         jsize idx) {
  (void)env;
  return ((FakeObj*)a)->o[idx];
}

static jint* env_GetIntArrayElements(JNIEnv* env, jintArray a,
                                     jboolean* copy) {
  (void)env;
  if (copy) *copy = 0;
  return ((FakeObj*)a)->i;
}

static void env_ReleaseIntArrayElements(JNIEnv* env, jintArray a,
                                        jint* v, jint mode) {
  (void)env;
  (void)a;
  (void)v;
  (void)mode;
}

static jfloat* env_GetFloatArrayElements(JNIEnv* env, jfloatArray a,
                                         jboolean* copy) {
  (void)env;
  if (copy) *copy = 0;
  return ((FakeObj*)a)->f;
}

static void env_ReleaseFloatArrayElements(JNIEnv* env, jfloatArray a,
                                          jfloat* v, jint mode) {
  (void)env;
  (void)a;
  (void)v;
  (void)mode;
}

/* ---- the Java_* entry points under test -------------------------- */
extern jlong Java_com_lightgbm_tpu_LightGBMNative_datasetCreateFromMat(
    JNIEnv*, jclass, jdoubleArray, jint, jint, jstring);
extern jlong
Java_com_lightgbm_tpu_LightGBMNative_datasetCreateFromMatWithReference(
    JNIEnv*, jclass, jdoubleArray, jint, jint, jstring, jlong);
extern jlong Java_com_lightgbm_tpu_LightGBMNative_datasetCreateFromFile(
    JNIEnv*, jclass, jstring, jstring);
extern jlong Java_com_lightgbm_tpu_LightGBMNative_datasetCreateFromCSR(
    JNIEnv*, jclass, jintArray, jintArray, jdoubleArray, jint, jstring);
extern jlong Java_com_lightgbm_tpu_LightGBMNative_datasetGetSubset(
    JNIEnv*, jclass, jlong, jintArray, jstring);
extern void Java_com_lightgbm_tpu_LightGBMNative_datasetSetField(
    JNIEnv*, jclass, jlong, jstring, jdoubleArray);
extern jint Java_com_lightgbm_tpu_LightGBMNative_datasetGetNumData(
    JNIEnv*, jclass, jlong);
extern jint Java_com_lightgbm_tpu_LightGBMNative_datasetGetNumFeature(
    JNIEnv*, jclass, jlong);
extern void Java_com_lightgbm_tpu_LightGBMNative_datasetSaveBinary(
    JNIEnv*, jclass, jlong, jstring);
extern void Java_com_lightgbm_tpu_LightGBMNative_datasetSetFeatureNames(
    JNIEnv*, jclass, jlong, jobjectArray);
extern jobjectArray
Java_com_lightgbm_tpu_LightGBMNative_datasetGetFeatureNames(
    JNIEnv*, jclass, jlong);
extern void Java_com_lightgbm_tpu_LightGBMNative_datasetFree(
    JNIEnv*, jclass, jlong);
extern jlong Java_com_lightgbm_tpu_LightGBMNative_boosterCreate(
    JNIEnv*, jclass, jlong, jstring);
extern jlong
Java_com_lightgbm_tpu_LightGBMNative_boosterCreateFromModelfile(
    JNIEnv*, jclass, jstring);
extern jlong
Java_com_lightgbm_tpu_LightGBMNative_boosterLoadModelFromString(
    JNIEnv*, jclass, jstring);
extern void Java_com_lightgbm_tpu_LightGBMNative_boosterAddValidData(
    JNIEnv*, jclass, jlong, jlong);
extern jint Java_com_lightgbm_tpu_LightGBMNative_boosterUpdateOneIter(
    JNIEnv*, jclass, jlong);
extern jint
Java_com_lightgbm_tpu_LightGBMNative_boosterUpdateOneIterCustom(
    JNIEnv*, jclass, jlong, jfloatArray, jfloatArray);
extern void Java_com_lightgbm_tpu_LightGBMNative_boosterRollbackOneIter(
    JNIEnv*, jclass, jlong);
extern jint Java_com_lightgbm_tpu_LightGBMNative_boosterGetNumClasses(
    JNIEnv*, jclass, jlong);
extern jint
Java_com_lightgbm_tpu_LightGBMNative_boosterGetCurrentIteration(
    JNIEnv*, jclass, jlong);
extern jint
Java_com_lightgbm_tpu_LightGBMNative_boosterNumberOfTotalModel(
    JNIEnv*, jclass, jlong);
extern jint Java_com_lightgbm_tpu_LightGBMNative_boosterGetNumFeature(
    JNIEnv*, jclass, jlong);
extern jobjectArray
Java_com_lightgbm_tpu_LightGBMNative_boosterGetFeatureNames(
    JNIEnv*, jclass, jlong);
extern jint Java_com_lightgbm_tpu_LightGBMNative_boosterGetEvalCounts(
    JNIEnv*, jclass, jlong);
extern jobjectArray
Java_com_lightgbm_tpu_LightGBMNative_boosterGetEvalNames(
    JNIEnv*, jclass, jlong);
extern jdoubleArray Java_com_lightgbm_tpu_LightGBMNative_boosterGetEval(
    JNIEnv*, jclass, jlong, jint);
extern void Java_com_lightgbm_tpu_LightGBMNative_boosterResetParameter(
    JNIEnv*, jclass, jlong, jstring);
extern void
Java_com_lightgbm_tpu_LightGBMNative_boosterResetTrainingData(
    JNIEnv*, jclass, jlong, jlong);
extern void Java_com_lightgbm_tpu_LightGBMNative_boosterMerge(
    JNIEnv*, jclass, jlong, jlong);
extern void Java_com_lightgbm_tpu_LightGBMNative_boosterSaveModel(
    JNIEnv*, jclass, jlong, jint, jstring);
extern jstring
Java_com_lightgbm_tpu_LightGBMNative_boosterSaveModelToString(
    JNIEnv*, jclass, jlong, jint);
extern jstring Java_com_lightgbm_tpu_LightGBMNative_boosterDumpModel(
    JNIEnv*, jclass, jlong, jint);
extern jdoubleArray
Java_com_lightgbm_tpu_LightGBMNative_boosterFeatureImportance(
    JNIEnv*, jclass, jlong, jint, jint);
extern jlong
Java_com_lightgbm_tpu_LightGBMNative_boosterCalcNumPredict(
    JNIEnv*, jclass, jlong, jint, jint, jint);
extern jdouble
Java_com_lightgbm_tpu_LightGBMNative_boosterGetLeafValue(
    JNIEnv*, jclass, jlong, jint, jint);
extern void Java_com_lightgbm_tpu_LightGBMNative_boosterSetLeafValue(
    JNIEnv*, jclass, jlong, jint, jint, jdouble);
extern jdoubleArray
Java_com_lightgbm_tpu_LightGBMNative_boosterPredictForMat(
    JNIEnv*, jclass, jlong, jdoubleArray, jint, jint, jint, jint);
extern jdoubleArray
Java_com_lightgbm_tpu_LightGBMNative_boosterPredictForCSR(
    JNIEnv*, jclass, jlong, jintArray, jintArray, jdoubleArray, jint,
    jint, jint);
extern void Java_com_lightgbm_tpu_LightGBMNative_boosterPredictForFile(
    JNIEnv*, jclass, jlong, jstring, jint, jint, jint, jstring);
extern void Java_com_lightgbm_tpu_LightGBMNative_boosterFree(
    JNIEnv*, jclass, jlong);

static unsigned long rng_state = 777;
static double frand(void) {
  rng_state ^= rng_state << 13;
  rng_state ^= rng_state >> 7;
  rng_state ^= rng_state << 17;
  return (double)(rng_state % 1000000ul) / 1000000.0 - 0.5;
}

/* verdicts leave through _exit: the embedded CPython with torch's
 * and CUDA's threads makes glibc DSO-destructor order hostile after main returns
 * (same post-main SIGSEGV class the R stub host hit once multiple
 * boosters existed) */
#define CHECK(cond, code, msg)                        \
  do {                                                \
    if (!(cond)) {                                    \
      fprintf(stderr, "FAIL(%d): %s\n", code, msg);  \
      fflush(NULL);                                   \
      _exit(code);                                    \
    }                                                 \
  } while (0)

static const char* g_device = "cuda";

/* "<params> device=<g_device>" as a Java string (mk_string keeps the
 * pointer, so the text lives on the heap; never freed: the host leaves
 * through _exit) */
static jstring with_device(const char* params) {
  size_t len = strlen(params) + strlen(g_device) + 9;
  char* buf = malloc(len);
  snprintf(buf, len, "%s%sdevice=%s", params, *params ? " " : "", g_device);
  return mk_string(buf);
}

int main(int argc, char** argv) {
  CHECK(argc > 2, 2, "usage: torch_jni_host_driver DEVICE MODEL_PATH");
  g_device = argv[1];
  const char* model_path = argv[2];
  char path2[1024];
  struct JNINativeInterface_ table = {
      .FindClass = env_FindClass,
      .ThrowNew = env_ThrowNew,
      .GetStringUTFChars = env_GetStringUTFChars,
      .ReleaseStringUTFChars = env_ReleaseStringUTFChars,
      .GetArrayLength = env_GetArrayLength,
      .NewDoubleArray = env_NewDoubleArray,
      .GetDoubleArrayElements = env_GetDoubleArrayElements,
      .ReleaseDoubleArrayElements = env_ReleaseDoubleArrayElements,
      .SetDoubleArrayRegion = env_SetDoubleArrayRegion,
      .NewStringUTF = env_NewStringUTF,
      .NewObjectArray = env_NewObjectArray,
      .SetObjectArrayElement = env_SetObjectArrayElement,
      .GetObjectArrayElement = env_GetObjectArrayElement,
      .GetIntArrayElements = env_GetIntArrayElements,
      .ReleaseIntArrayElements = env_ReleaseIntArrayElements,
      .GetFloatArrayElements = env_GetFloatArrayElements,
      .ReleaseFloatArrayElements = env_ReleaseFloatArrayElements,
  };
  JNIEnv env_obj = &table;
  JNIEnv* env = &env_obj;

  const int n = 500, f = 4, nv = 150;
  double* mat = malloc(sizeof(double) * n * f); /* row-major (Java) */
  double* label = malloc(sizeof(double) * n);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < f; ++j) mat[i * f + j] = frand();
    label[i] = (mat[i * f] + 0.5 * mat[i * f + 1] > 0.0) ? 1.0 : 0.0;
  }
  double* vmat = malloc(sizeof(double) * nv * f);
  double* vlabel = malloc(sizeof(double) * nv);
  for (int i = 0; i < nv; ++i) {
    for (int j = 0; j < f; ++j) vmat[i * f + j] = frand();
    vlabel[i] = (vmat[i * f] + 0.5 * vmat[i * f + 1] > 0.0) ? 1.0 : 0.0;
  }

  jdoubleArray j_mat = mk_darray(mat, n * f);
  jstring params = with_device(
      "objective=binary verbose=-1 num_leaves=15 min_data_in_leaf=5");
  jlong ds = Java_com_lightgbm_tpu_LightGBMNative_datasetCreateFromMat(
      env, NULL, j_mat, n, f, params);
  Java_com_lightgbm_tpu_LightGBMNative_datasetSetField(
      env, NULL, ds, mk_string("label"), mk_darray(label, n));
  jlong bst = Java_com_lightgbm_tpu_LightGBMNative_boosterCreate(
      env, NULL, ds, params);
  for (int it = 0; it < 20; ++it)
    Java_com_lightgbm_tpu_LightGBMNative_boosterUpdateOneIter(env, NULL,
                                                              bst);
  jdoubleArray pred =
      Java_com_lightgbm_tpu_LightGBMNative_boosterPredictForMat(
          env, NULL, bst, j_mat, n, f, 0, -1);
  CHECK(env_GetArrayLength(env, pred) == n, 4, "prediction length");
  double* p = env_GetDoubleArrayElements(env, pred, NULL);
  int correct = 0;
  for (int i = 0; i < n; ++i)
    correct += ((p[i] > 0.5) == (label[i] > 0.5));
  double acc = (double)correct / n;

  Java_com_lightgbm_tpu_LightGBMNative_boosterSaveModel(
      env, NULL, bst, -1, mk_string(model_path));
  jlong bst2 =
      Java_com_lightgbm_tpu_LightGBMNative_boosterCreateFromModelfile(
          env, NULL, mk_string(model_path));
  Java_com_lightgbm_tpu_LightGBMNative_boosterResetParameter(
      env, NULL, bst2, with_device(""));
  jdoubleArray pred2 =
      Java_com_lightgbm_tpu_LightGBMNative_boosterPredictForMat(
          env, NULL, bst2, j_mat, n, f, 0, -1);
  double* p2 = env_GetDoubleArrayElements(env, pred2, NULL);
  double maxdiff = 0.0;
  for (int i = 0; i < n; ++i) {
    double d = fabs(p[i] - p2[i]);
    if (d > maxdiff) maxdiff = d;
  }
  CHECK(acc >= 0.85, 5, "training accuracy");
  CHECK(maxdiff <= 1e-10, 6, "save/reload parity");

  /* ---- getters ---------------------------------------------------- */
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_datasetGetNumData(
            env, NULL, ds) == n, 10, "datasetGetNumData");
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_datasetGetNumFeature(
            env, NULL, ds) == f, 11, "datasetGetNumFeature");
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_boosterGetNumClasses(
            env, NULL, bst) == 1, 12, "boosterGetNumClasses");
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_boosterGetNumFeature(
            env, NULL, bst) == f, 13, "boosterGetNumFeature");
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_boosterNumberOfTotalModel(
            env, NULL, bst) == 20, 14, "boosterNumberOfTotalModel");
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_boosterGetCurrentIteration(
            env, NULL, bst) == 20, 15, "boosterGetCurrentIteration");
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_boosterCalcNumPredict(
            env, NULL, bst, n, 0, -1) == n, 16, "boosterCalcNumPredict");

  /* ---- CSR predict parity (all entries explicit) ------------------ */
  int* indptr = malloc(sizeof(int) * (n + 1));
  int* indices = malloc(sizeof(int) * n * f);
  for (int i = 0; i <= n; ++i) indptr[i] = i * f;
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < f; ++j) indices[i * f + j] = j;
  jintArray j_indptr = mk_iarray(indptr, n + 1);
  jintArray j_indices = mk_iarray(indices, n * f);
  jdoubleArray pred_csr =
      Java_com_lightgbm_tpu_LightGBMNative_boosterPredictForCSR(
          env, NULL, bst, j_indptr, j_indices, j_mat, f, 0, -1);
  CHECK(env_GetArrayLength(env, pred_csr) == n, 17, "CSR pred length");
  double* pc = env_GetDoubleArrayElements(env, pred_csr, NULL);
  double csr_diff = 0.0;
  for (int i = 0; i < n; ++i) {
    double d = fabs(p[i] - pc[i]);
    if (d > csr_diff) csr_diff = d;
  }
  CHECK(csr_diff <= 1e-10, 18, "CSR vs dense predict parity");

  /* ---- CSR dataset trains ----------------------------------------- */
  jlong ds_csr =
      Java_com_lightgbm_tpu_LightGBMNative_datasetCreateFromCSR(
          env, NULL, j_indptr, j_indices, j_mat, f, params);
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_datasetGetNumData(
            env, NULL, ds_csr) == n, 19, "CSR dataset rows");
  Java_com_lightgbm_tpu_LightGBMNative_datasetSetField(
      env, NULL, ds_csr, mk_string("label"), mk_darray(label, n));
  jlong bst_csr = Java_com_lightgbm_tpu_LightGBMNative_boosterCreate(
      env, NULL, ds_csr, params);
  for (int it = 0; it < 3; ++it)
    Java_com_lightgbm_tpu_LightGBMNative_boosterUpdateOneIter(
        env, NULL, bst_csr);
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_boosterGetCurrentIteration(
            env, NULL, bst_csr) == 3, 20, "CSR booster trained");

  /* ---- valid-set eval flow ---------------------------------------- */
  jdoubleArray j_vmat = mk_darray(vmat, nv * f);
  jlong dsv = Java_com_lightgbm_tpu_LightGBMNative_datasetCreateFromMatWithReference(
      env, NULL, j_vmat, nv, f, params, ds);
  Java_com_lightgbm_tpu_LightGBMNative_datasetSetField(
      env, NULL, dsv, mk_string("label"), mk_darray(vlabel, nv));
  jlong bst_e = Java_com_lightgbm_tpu_LightGBMNative_boosterCreate(
      env, NULL, ds, params);
  Java_com_lightgbm_tpu_LightGBMNative_boosterAddValidData(
      env, NULL, bst_e, dsv);
  for (int it = 0; it < 3; ++it)
    Java_com_lightgbm_tpu_LightGBMNative_boosterUpdateOneIter(
        env, NULL, bst_e);
  int ev_counts = Java_com_lightgbm_tpu_LightGBMNative_boosterGetEvalCounts(
      env, NULL, bst_e);
  CHECK(ev_counts >= 1, 21, "eval counts");
  jobjectArray ev_names =
      Java_com_lightgbm_tpu_LightGBMNative_boosterGetEvalNames(
          env, NULL, bst_e);
  CHECK(env_GetArrayLength(env, ev_names) == ev_counts, 22,
        "eval names count");
  const char* ev0_name = env_GetStringUTFChars(
      env, env_GetObjectArrayElement(env, ev_names, 0), NULL);
  CHECK(strlen(ev0_name) > 0, 23, "eval name nonempty");
  for (int di = 0; di <= 1; ++di) {
    jdoubleArray ev = Java_com_lightgbm_tpu_LightGBMNative_boosterGetEval(
        env, NULL, bst_e, di);
    jsize ne = env_GetArrayLength(env, ev);
    CHECK(ne == ev_counts, 24, "eval values count");
    double* evv = env_GetDoubleArrayElements(env, ev, NULL);
    for (jsize k = 0; k < ne; ++k)
      CHECK(evv[k] == evv[k], 25, "eval value is NaN");
  }

  /* ---- custom-objective iteration + rollback ----------------------- */
  jdoubleArray pe = Java_com_lightgbm_tpu_LightGBMNative_boosterPredictForMat(
      env, NULL, bst_e, j_mat, n, f, 0, -1);
  double* pev = env_GetDoubleArrayElements(env, pe, NULL);
  float* grad = malloc(sizeof(float) * n);
  float* hess = malloc(sizeof(float) * n);
  for (int i = 0; i < n; ++i) {
    grad[i] = (float)(pev[i] - label[i]);
    hess[i] = (float)(pev[i] * (1.0 - pev[i]) + 1e-6);
  }
  Java_com_lightgbm_tpu_LightGBMNative_boosterUpdateOneIterCustom(
      env, NULL, bst_e, mk_farray(grad, n), mk_farray(hess, n));
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_boosterGetCurrentIteration(
            env, NULL, bst_e) == 4, 26, "custom iter advanced");
  Java_com_lightgbm_tpu_LightGBMNative_boosterRollbackOneIter(
      env, NULL, bst_e);
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_boosterGetCurrentIteration(
            env, NULL, bst_e) == 3, 27, "rollback");
  Java_com_lightgbm_tpu_LightGBMNative_boosterResetParameter(
      env, NULL, bst_e, with_device("learning_rate=0.05"));

  /* ---- model string round trip + dump ------------------------------ */
  jstring mstr = Java_com_lightgbm_tpu_LightGBMNative_boosterSaveModelToString(
      env, NULL, bst, -1);
  const char* mtxt = env_GetStringUTFChars(env, mstr, NULL);
  CHECK(strlen(mtxt) > 100, 28, "model string length");
  jlong bst3 = Java_com_lightgbm_tpu_LightGBMNative_boosterLoadModelFromString(
      env, NULL, mstr);
  Java_com_lightgbm_tpu_LightGBMNative_boosterResetParameter(
      env, NULL, bst3, with_device(""));
  jdoubleArray pred3 =
      Java_com_lightgbm_tpu_LightGBMNative_boosterPredictForMat(
          env, NULL, bst3, j_mat, n, f, 0, -1);
  double* p3 = env_GetDoubleArrayElements(env, pred3, NULL);
  double sdiff = 0.0;
  for (int i = 0; i < n; ++i) {
    double d = fabs(p[i] - p3[i]);
    if (d > sdiff) sdiff = d;
  }
  CHECK(sdiff <= 1e-10, 29, "string save/load parity");
  jstring dump = Java_com_lightgbm_tpu_LightGBMNative_boosterDumpModel(
      env, NULL, bst, -1);
  const char* dtxt = env_GetStringUTFChars(env, dump, NULL);
  CHECK(strstr(dtxt, "tree") != NULL, 30, "dump contains trees");

  /* ---- importance, leaf mutation, merge ---------------------------- */
  jdoubleArray imp =
      Java_com_lightgbm_tpu_LightGBMNative_boosterFeatureImportance(
          env, NULL, bst, -1, 0);
  CHECK(env_GetArrayLength(env, imp) == f, 31, "importance length");
  double* iv = env_GetDoubleArrayElements(env, imp, NULL);
  double isum = 0.0;
  for (int j = 0; j < f; ++j) isum += iv[j];
  CHECK(isum > 0.0, 32, "importance sum");

  double leaf0 = Java_com_lightgbm_tpu_LightGBMNative_boosterGetLeafValue(
      env, NULL, bst3, 0, 0);
  Java_com_lightgbm_tpu_LightGBMNative_boosterSetLeafValue(
      env, NULL, bst3, 0, 0, leaf0 + 0.5);
  double leaf1 = Java_com_lightgbm_tpu_LightGBMNative_boosterGetLeafValue(
      env, NULL, bst3, 0, 0);
  CHECK(fabs(leaf1 - (leaf0 + 0.5)) < 1e-12, 33, "leaf set/get");

  jlong bst4 = Java_com_lightgbm_tpu_LightGBMNative_boosterLoadModelFromString(
      env, NULL, mstr);
  Java_com_lightgbm_tpu_LightGBMNative_boosterResetParameter(
      env, NULL, bst4, with_device(""));
  Java_com_lightgbm_tpu_LightGBMNative_boosterMerge(env, NULL, bst4,
                                                    bst);
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_boosterNumberOfTotalModel(
            env, NULL, bst4) == 40, 34, "merge tree count");

  /* ---- subset, binary save, feature names -------------------------- */
  int subrows[100];
  for (int i = 0; i < 100; ++i) subrows[i] = i;
  jlong sub = Java_com_lightgbm_tpu_LightGBMNative_datasetGetSubset(
      env, NULL, ds, mk_iarray(subrows, 100), with_device(""));
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_datasetGetNumData(
            env, NULL, sub) == 100, 35, "subset rows");
  snprintf(path2, sizeof(path2), "%s.dsbin", model_path);
  Java_com_lightgbm_tpu_LightGBMNative_datasetSaveBinary(
      env, NULL, ds, mk_string(path2));
  FILE* fh = fopen(path2, "rb");
  CHECK(fh != NULL, 36, "dataset binary saved");
  fclose(fh);

  jobjectArray names = env_NewObjectArray(env, f, NULL, NULL);
  env_SetObjectArrayElement(env, names, 0, mk_string("fa"));
  env_SetObjectArrayElement(env, names, 1, mk_string("fb"));
  env_SetObjectArrayElement(env, names, 2, mk_string("fc"));
  env_SetObjectArrayElement(env, names, 3, mk_string("fd"));
  Java_com_lightgbm_tpu_LightGBMNative_datasetSetFeatureNames(
      env, NULL, ds, names);
  jobjectArray got =
      Java_com_lightgbm_tpu_LightGBMNative_datasetGetFeatureNames(
          env, NULL, ds);
  CHECK(env_GetArrayLength(env, got) == f, 37, "feature names count");
  const char* fc = env_GetStringUTFChars(
      env, env_GetObjectArrayElement(env, got, 2), NULL);
  CHECK(strcmp(fc, "fc") == 0, 38, "feature name round trip");
  jobjectArray bnames =
      Java_com_lightgbm_tpu_LightGBMNative_boosterGetFeatureNames(
          env, NULL, bst);
  CHECK(env_GetArrayLength(env, bnames) == f, 39,
        "booster feature names count");

  /* ---- file prediction --------------------------------------------- */
  snprintf(path2, sizeof(path2), "%s.pred_in.csv", model_path);
  FILE* pf = fopen(path2, "w");
  CHECK(pf != NULL, 40, "predict input open");
  for (int i = 0; i < nv; ++i) {
    fprintf(pf, "%g", vlabel[i]);
    for (int j = 0; j < f; ++j) fprintf(pf, ",%g", vmat[i * f + j]);
    fprintf(pf, "\n");
  }
  fclose(pf);
  char rpath[1024];
  snprintf(rpath, sizeof(rpath), "%s.pred_out.txt", model_path);
  Java_com_lightgbm_tpu_LightGBMNative_boosterPredictForFile(
      env, NULL, bst, mk_string(path2), 0, 0, -1, mk_string(rpath));
  FILE* rf = fopen(rpath, "r");
  CHECK(rf != NULL, 41, "predict output exists");
  int lines = 0, ch;
  while ((ch = fgetc(rf)) != EOF)
    if (ch == '\n') ++lines;
  fclose(rf);
  CHECK(lines == nv, 42, "predict output rows");

  /* ---- dataset from text file + training-data swap ----------------- */
  jlong ds_file =
      Java_com_lightgbm_tpu_LightGBMNative_datasetCreateFromFile(
          env, NULL, mk_string(path2), params);
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_datasetGetNumData(
            env, NULL, ds_file) == nv, 43, "file dataset rows");
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_datasetGetNumFeature(
            env, NULL, ds_file) == f, 44, "file dataset features");
  Java_com_lightgbm_tpu_LightGBMNative_boosterResetTrainingData(
      env, NULL, bst_e, ds_file);
  Java_com_lightgbm_tpu_LightGBMNative_boosterUpdateOneIter(env, NULL,
                                                            bst_e);
  CHECK(Java_com_lightgbm_tpu_LightGBMNative_boosterGetCurrentIteration(
            env, NULL, bst_e) == 4, 45, "trains on swapped data");
  Java_com_lightgbm_tpu_LightGBMNative_datasetFree(env, NULL, ds_file);

  Java_com_lightgbm_tpu_LightGBMNative_boosterFree(env, NULL, bst);
  Java_com_lightgbm_tpu_LightGBMNative_boosterFree(env, NULL, bst2);
  Java_com_lightgbm_tpu_LightGBMNative_boosterFree(env, NULL, bst3);
  Java_com_lightgbm_tpu_LightGBMNative_boosterFree(env, NULL, bst4);
  Java_com_lightgbm_tpu_LightGBMNative_boosterFree(env, NULL, bst_e);
  Java_com_lightgbm_tpu_LightGBMNative_boosterFree(env, NULL, bst_csr);
  Java_com_lightgbm_tpu_LightGBMNative_datasetFree(env, NULL, sub);
  Java_com_lightgbm_tpu_LightGBMNative_datasetFree(env, NULL, dsv);
  Java_com_lightgbm_tpu_LightGBMNative_datasetFree(env, NULL, ds_csr);
  Java_com_lightgbm_tpu_LightGBMNative_datasetFree(env, NULL, ds);
  printf("JNI-HOST OK acc=%.3f maxdiff=%g\n", acc, maxdiff);
  fflush(NULL);
  _exit(0);
}
