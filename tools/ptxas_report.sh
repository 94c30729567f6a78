#!/bin/sh
# Print each kernel's registers, shared memory and spills in one CUDA source
# of the port, as ptxas reports them for sm_90a (the build's flags), then
# each kernel's count of tensor-core instructions (HMMA / HGMMA) in its SASS:
#     sh tools/ptxas_report.sh flash_bwd.cu
nvcc=${NVCC:-$(command -v nvcc || echo /usr/local/cuda/bin/nvcc)}
src=$(dirname "$0")/../src/repro_torch/kernels/csrc/$1
out=$(mktemp -d)
"$nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
    -Xcompiler -fPIC -Xptxas -v -o "$out/lib.so" "$src" 2>&1 \
    | grep -E "Compiling entry|registers|spill" \
    | sed -e 's/ptxas info *: //'
"$(dirname "$nvcc")/cuobjdump" -sass "$out/lib.so" \
    | awk '/Function :/ { name = $3; n[name] += 0 }
           /HMMA|HGMMA/ { n[name]++; kind[name] = $2 }
           END { for (f in n) print f ": " n[f] " tensor-core instructions " kind[f] }'
rm -rf "$out"
