/*
 * lightgbm_tpu_torch C API — native embedding surface for non-Python
 * hosts (liblgbm_tpu_torch.so, built by
 * lightgbm_tpu_torch.native.capi.build_capi).
 *
 * Plays the role of the reference's flat C API
 * (reference: include/LightGBM/c_api.h, src/c_api.cpp) with the same
 * function names, handle discipline and 0/-1 + LGBM_GetLastError error
 * convention (reference c_api.h:765-788), and the same ABI as the JAX
 * package's lightgbm_tpu/native/include/lightgbm_tpu_c_api.h.  The
 * stack is inverted relative to the reference: the core is the
 * PyTorch/CUDA port, so this library embeds CPython (linked against
 * libpython) and forwards each call to lightgbm_tpu_torch.capi.  R's
 * .Call shim or a Java JNI wrapper links against this exactly the way
 * the reference's R-package/src/lightgbm_R.cpp links against
 * lib_lightgbm.
 *
 * Device: a booster trains and predicts on the CUDA card unless
 * "device=cpu" is among its parameters; a model loaded from a file or
 * a string takes its device through LGBM_BoosterResetParameter.  No
 * environment variable picks it, and nothing falls back to the CPU.
 *
 * Threading: every entry point acquires the GIL; concurrent calls from
 * multiple host threads serialize (the reference serializes Booster
 * mutations with a std::mutex, c_api.cpp:67,311 — same effective
 * discipline).
 *
 * Environment: the embedded interpreter must be able to import
 * `lightgbm_tpu_torch` (set PYTHONPATH, or call LTPU_AddSysPath
 * first).  The interpreter is never finalized: hosts exit with _exit()
 * (lightgbm_tpu_torch/native/README.md).
 */
#ifndef LIGHTGBM_TPU_C_API_H_
#define LIGHTGBM_TPU_C_API_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* DatasetHandle;
typedef void* BoosterHandle;

/* dtype codes (reference c_api.h:33-41) */
#define C_API_DTYPE_FLOAT32 (0)
#define C_API_DTYPE_FLOAT64 (1)
#define C_API_DTYPE_INT32   (2)
#define C_API_DTYPE_INT64   (3)

/* predict task codes (reference c_api.h:43-47) */
#define C_API_PREDICT_NORMAL     (0)
#define C_API_PREDICT_RAW_SCORE  (1)
#define C_API_PREDICT_LEAF_INDEX (2)
#define C_API_PREDICT_CONTRIB    (3)

/* ---- embedding helpers (no reference analog; interpreter control) */
/* Append a directory to the embedded interpreter's sys.path BEFORE the
 * first API call (so `import lightgbm_tpu_torch` resolves). */
int LTPU_AddSysPath(const char* path);
/* Force interpreter + module initialization now (otherwise lazy). */
int LTPU_EnsureInitialized(void);

/* ---- error handling */
const char* LGBM_GetLastError(void);
/* reference c_api.h:768 — embedders (custom objectives calling back
 * into the host) set the error slot themselves. */
int LGBM_SetLastError(const char* msg);

/* ---- Dataset */
int LGBM_DatasetCreateFromFile(const char* filename, const char* parameters,
                               const DatasetHandle reference,
                               DatasetHandle* out);
int LGBM_DatasetCreateFromMat(const void* data, int data_type, int32_t nrow,
                              int32_t ncol, int is_row_major,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);
int LGBM_DatasetSetField(DatasetHandle handle, const char* field_name,
                         const void* field_data, int num_element, int type);
/* out_ptr stays valid until the next GetField on the same handle or
 * DatasetFree (the reference returns a pointer into the Dataset too). */
int LGBM_DatasetGetField(DatasetHandle handle, const char* field_name,
                         int* out_len, const void** out_ptr, int* out_type);
int LGBM_DatasetGetNumData(DatasetHandle handle, int32_t* out);
int LGBM_DatasetGetNumFeature(DatasetHandle handle, int32_t* out);
int LGBM_DatasetSaveBinary(DatasetHandle handle, const char* filename);
int LGBM_DatasetFree(DatasetHandle handle);
/* CSR rows (reference c_api.h:147-180).  indptr_type / data_type are
 * C_API_DTYPE_* codes; indices are int32. */
int LGBM_DatasetCreateFromCSR(const void* indptr, int indptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t nindptr, int64_t nelem,
                              int64_t num_col, const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);
/* CSC columns (reference c_api.h:183-216). */
int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t ncol_ptr, int64_t nelem,
                              int64_t num_row, const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out);
/* Row subset sharing the parent's bin mappers (reference
 * c_api.h:195-210). */
int LGBM_DatasetGetSubset(const DatasetHandle handle,
                          const int32_t* used_row_indices,
                          int32_t num_used_row_indices,
                          const char* parameters, DatasetHandle* out);
/* Feature names (reference c_api.h:212-230).  On Get, each
 * out_strs[i] must point at a caller buffer of >= 256 bytes; pass
 * out_strs == NULL to only query the count. */
int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                const char** feature_names,
                                int num_feature_names);
int LGBM_DatasetGetFeatureNames(DatasetHandle handle, char** out_strs,
                                int* out_len);
/* Streaming ingestion (reference c_api.h:68-145): mappers fitted from
 * per-column samples (or copied from an existing dataset), then rows
 * pushed in chunks. */
int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                  int64_t num_total_row,
                                  DatasetHandle* out);
int LGBM_DatasetPushRows(DatasetHandle handle, const void* data,
                         int data_type, int32_t nrow, int32_t ncol,
                         int32_t start_row);
int LGBM_DatasetPushRowsByCSR(DatasetHandle handle, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int64_t start_row);

/* ---- Booster */
int LGBM_BoosterCreate(const DatasetHandle train_data,
                       const char* parameters, BoosterHandle* out);
int LGBM_BoosterCreateFromModelfile(const char* filename,
                                    int* out_num_iterations,
                                    BoosterHandle* out);
int LGBM_BoosterLoadModelFromString(const char* model_str,
                                    int* out_num_iterations,
                                    BoosterHandle* out);
int LGBM_BoosterFree(BoosterHandle handle);
int LGBM_BoosterAddValidData(BoosterHandle handle,
                             const DatasetHandle valid_data);
int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len);
int LGBM_BoosterUpdateOneIter(BoosterHandle handle, int* is_finished);
int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle, const float* grad,
                                    const float* hess, int64_t num_elements,
                                    int* is_finished);
int LGBM_BoosterRollbackOneIter(BoosterHandle handle);
int LGBM_BoosterGetCurrentIteration(BoosterHandle handle,
                                    int* out_iteration);
/* Number of metric values per dataset — size the GetEval buffer with
 * this first (reference c_api.h:430-437). */
int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len);
int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx, int* out_len,
                        double* out_results);
int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data,
                              int data_type, int32_t nrow, int32_t ncol,
                              int is_row_major, int predict_type,
                              int num_iteration, const char* parameter,
                              int64_t* out_len, double* out_result);
int LGBM_BoosterSaveModel(BoosterHandle handle, int num_iteration,
                          const char* filename);
int LGBM_BoosterSaveModelToString(BoosterHandle handle, int num_iteration,
                                  int64_t buffer_len, int64_t* out_len,
                                  char* out_str);
int LGBM_BoosterDumpModel(BoosterHandle handle, int num_iteration,
                          int64_t buffer_len, int64_t* out_len,
                          char* out_str);
int LGBM_BoosterFeatureImportance(BoosterHandle handle, int num_iteration,
                                  int importance_type, double* out_results);
/* Append other's trees onto handle (reference c_api.h:330-338). */
int LGBM_BoosterMerge(BoosterHandle handle, BoosterHandle other_handle);
int LGBM_BoosterNumberOfTotalModel(BoosterHandle handle, int* out_models);
int LGBM_BoosterResetParameter(BoosterHandle handle,
                               const char* parameters);
int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                  const DatasetHandle train_data);
int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len);
/* Name lists: each out_strs[i] must point at a caller buffer of
 * >= 256 bytes; pass out_strs == NULL to only query the count
 * (reference c_api.h:430-446). */
int LGBM_BoosterGetFeatureNames(BoosterHandle handle, int* out_len,
                                char** out_strs);
int LGBM_BoosterGetEvalNames(BoosterHandle handle, int* out_len,
                             char** out_strs);
/* Converted in-training scores of train (data_idx 0) / valid set
 * data_idx-1 (reference c_api.h:520-548).  Size out_result with
 * GetNumPredict first. */
int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                              int64_t* out_len);
int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                           int64_t* out_len, double* out_result);
int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double* out_val);
int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double val);
/* Result-buffer size for a prediction call (reference
 * c_api.h:520-535). */
int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
                               int predict_type, int num_iteration,
                               int64_t* out_len);
/* Sparse prediction (reference c_api.h:574-659).  parameter is
 * reserved (the reference parses extra predict params there). */
int LGBM_BoosterPredictForCSR(BoosterHandle handle, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int predict_type,
                              int num_iteration, const char* parameter,
                              int64_t* out_len, double* out_result);
int LGBM_BoosterPredictForCSC(BoosterHandle handle, const void* col_ptr,
                              int col_ptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t ncol_ptr, int64_t nelem,
                              int64_t num_row, int predict_type,
                              int num_iteration, const char* parameter,
                              int64_t* out_len, double* out_result);
/* Batch file prediction, one row per line (reference
 * c_api.h:495-518). */
int LGBM_BoosterPredictForFile(BoosterHandle handle,
                               const char* data_filename,
                               int data_has_header, int predict_type,
                               int num_iteration, const char* parameter,
                               const char* result_filename);

/* ---- Network (reference c_api.h:749-762; see capi.py: rendezvous
 * goes through lightgbm_tpu_torch.parallel.distributed.initialize,
 * these warn and succeed) */
int LGBM_NetworkInit(const char* machines, int local_listen_port,
                     int listen_time_out, int num_machines);
int LGBM_NetworkFree(void);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* LIGHTGBM_TPU_C_API_H_ */
