// The general E-step kernel (estep_general.cuh) for J = 13 sources: one
// translation unit per J, so the build compiles them in parallel.
#include "estep_general.cuh"

PYFASST_ESTEP_GENERAL_ENTRY(13)
