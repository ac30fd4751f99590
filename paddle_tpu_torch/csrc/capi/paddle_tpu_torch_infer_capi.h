/* paddle_tpu_torch C inference API: Paddle's C client surface
 * (pd_inference_api.h: PD_Config, PD_Predictor, PD_Tensor) over the
 * port's Predictor.
 *
 * Scope: float32 tensors (CopyFromCpuFloat / CopyToCpuFloat) and int64
 * inputs (CopyFromCpuInt64, for token ids), model loading from a jit.save
 * prefix, input / output handles, Run, per-thread Clone. The library
 * embeds the Python runtime (libpython) and drives
 * paddle_tpu_torch.inference: the exported torch program does the work,
 * on the device it was saved from; this shim is the C ABI.
 *
 * Thread-safety: calls take the GIL; use one PD_Predictor per thread
 * via PD_PredictorClone (clones share the program and its weights).
 */
#ifndef PADDLE_TPU_TORCH_INFER_CAPI_H_
#define PADDLE_TPU_TORCH_INFER_CAPI_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct PD_Config PD_Config;
typedef struct PD_Predictor PD_Predictor;
typedef struct PD_Tensor PD_Tensor;

/* config ------------------------------------------------------------- */
PD_Config* PD_ConfigCreate(void);
/* prefix of the jit.save artifact (…/model -> model.pdmodel + params) */
void PD_ConfigSetModel(PD_Config* c, const char* prog_prefix,
                       const char* params_file /* may be NULL */);
void PD_ConfigDestroy(PD_Config* c);

/* predictor ---------------------------------------------------------- */
PD_Predictor* PD_PredictorCreate(PD_Config* c);      /* NULL on failure */
PD_Predictor* PD_PredictorClone(PD_Predictor* p);
void PD_PredictorDestroy(PD_Predictor* p);

int PD_PredictorGetInputNum(PD_Predictor* p);
int PD_PredictorGetOutputNum(PD_Predictor* p);       /* valid after Run */
/* returned string is owned by the predictor; valid until Destroy */
const char* PD_PredictorGetInputName(PD_Predictor* p, int i);
const char* PD_PredictorGetOutputName(PD_Predictor* p, int i);

PD_Tensor* PD_PredictorGetInputHandle(PD_Predictor* p, const char* name);
PD_Tensor* PD_PredictorGetOutputHandle(PD_Predictor* p, const char* name);

/* tensors ------------------------------------------------------------ */
void PD_TensorReshape(PD_Tensor* t, int ndim, const int64_t* shape);
void PD_TensorCopyFromCpuFloat(PD_Tensor* t, const float* data);
void PD_TensorCopyFromCpuInt64(PD_Tensor* t, const int64_t* data);
void PD_TensorCopyToCpuFloat(PD_Tensor* t, float* data);
int PD_TensorGetNumDims(PD_Tensor* t);
void PD_TensorGetShape(PD_Tensor* t, int64_t* shape_out);
void PD_TensorDestroy(PD_Tensor* t);                 /* handle only */

/* 0 on success */
int PD_PredictorRun(PD_Predictor* p);

/* last error message ("" when none); owned by the library */
const char* PD_GetLastError(void);

#ifdef __cplusplus
}
#endif
#endif /* PADDLE_TPU_TORCH_INFER_CAPI_H_ */
