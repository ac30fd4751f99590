/* A C client of the inference API: runs a jit.save artifact on one
 * float32 input read from a file and writes the first output to a file,
 * then runs a clone of the predictor on a second thread on the same input
 * and writes its output beside it.
 *
 *   predict_client PREFIX INPUT.f32 OUTPUT.f32 NDIM D0 D1 ...
 *
 * Prints "out NDIM: D0 D1 ..." for the output. Exit codes: 0 success,
 * 1 usage or file error, 2 predictor creation failed, 3 run failed,
 * 4 the clone's thread failed. Build (paddle_tpu_torch.inference.capi):
 *   gcc predict_client.c -I<include_dir> <library> -lpthread -o client
 */
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "paddle_tpu_torch_infer_capi.h"

struct Job {
  PD_Predictor* pred;
  const float* in;
  int ndim;
  const int64_t* shape;
  float* out;
  long long out_n;
  int rc;
};

/* one run: input handle 0 <- in, run, output 0 -> out (allocated) */
static int run_once(struct Job* job) {
  PD_Tensor* in = PD_PredictorGetInputHandle(
      job->pred, PD_PredictorGetInputName(job->pred, 0));
  PD_TensorReshape(in, job->ndim, job->shape);
  PD_TensorCopyFromCpuFloat(in, job->in);
  if (PD_PredictorRun(job->pred) != 0) return 3;
  PD_Tensor* out = PD_PredictorGetOutputHandle(
      job->pred, PD_PredictorGetOutputName(job->pred, 0));
  int nd = PD_TensorGetNumDims(out);
  int64_t oshape[8];
  if (nd > 8) return 3;
  PD_TensorGetShape(out, oshape);
  long long n = 1;
  for (int i = 0; i < nd; ++i) n *= oshape[i];
  job->out = (float*)malloc(sizeof(float) * (size_t)n);
  job->out_n = n;
  PD_TensorCopyToCpuFloat(out, job->out);
  if (job->pred != NULL && job->rc == -1) {
    printf("out %d:", nd);
    for (int i = 0; i < nd; ++i) printf(" %lld", (long long)oshape[i]);
    printf("\n");
  }
  return 0;
}

static void* run_thread(void* arg) {
  struct Job* job = (struct Job*)arg;
  job->rc = run_once(job);
  return NULL;
}

static int write_floats(const char* path, const float* data, long long n) {
  FILE* f = fopen(path, "wb");
  if (f == NULL) return 1;
  size_t w = fwrite(data, sizeof(float), (size_t)n, f);
  fclose(f);
  return w == (size_t)n ? 0 : 1;
}

int main(int argc, char** argv) {
  if (argc < 6) {
    fprintf(stderr, "usage: %s PREFIX IN OUT NDIM D0 ...\n", argv[0]);
    return 1;
  }
  int ndim = atoi(argv[4]);
  if (ndim < 1 || ndim > 8 || argc != 5 + ndim) return 1;
  int64_t shape[8];
  long long n = 1;
  for (int i = 0; i < ndim; ++i) {
    shape[i] = atoll(argv[5 + i]);
    n *= shape[i];
  }
  float* data = (float*)malloc(sizeof(float) * (size_t)n);
  FILE* f = fopen(argv[2], "rb");
  if (f == NULL || fread(data, sizeof(float), (size_t)n, f) != (size_t)n) {
    fprintf(stderr, "cannot read %lld floats from %s\n", n, argv[2]);
    return 1;
  }
  fclose(f);

  PD_Config* cfg = PD_ConfigCreate();
  PD_ConfigSetModel(cfg, argv[1], NULL);
  PD_Predictor* pred = PD_PredictorCreate(cfg);
  PD_ConfigDestroy(cfg);
  if (pred == NULL) {
    fprintf(stderr, "create: %s\n", PD_GetLastError());
    return 2;
  }
  struct Job job = {pred, data, ndim, shape, NULL, 0, -1};
  if (run_once(&job) != 0) {
    fprintf(stderr, "run: %s\n", PD_GetLastError());
    return 3;
  }
  if (write_floats(argv[3], job.out, job.out_n) != 0) return 1;

  /* a clone serves from a second thread (the library parks the GIL) */
  PD_Predictor* clone = PD_PredictorClone(pred);
  struct Job cjob = {clone, data, ndim, shape, NULL, 0, 0};
  pthread_t th;
  if (clone == NULL || pthread_create(&th, NULL, run_thread, &cjob) != 0 ||
      pthread_join(th, NULL) != 0 || cjob.rc != 0) {
    fprintf(stderr, "clone: %s\n", PD_GetLastError());
    return 4;
  }
  char path[4096];
  snprintf(path, sizeof(path), "%s.clone", argv[3]);
  if (write_floats(path, cjob.out, cjob.out_n) != 0) return 1;

  free(job.out);
  free(cjob.out);
  free(data);
  PD_PredictorDestroy(clone);
  PD_PredictorDestroy(pred);
  return 0;
}
