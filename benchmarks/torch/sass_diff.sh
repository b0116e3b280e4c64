#!/bin/bash
# Whether one kernel source compiles to the same machine code in two
# checkouts, on the machine with the card (nvcc and cuobjdump of the CUDA
# toolkit):
#
#     git archive <commit> | tar -x -C build/parent
#     bash benchmarks/torch/sass_diff.sh paged_decode_attention build/parent [.]
#
# Builds deepspeed_tpu_torch/ops/csrc/<kernel>.cu of each checkout with the
# port's nvcc flags into build/sass/, dumps the SASS of every function with
# the anonymous namespace's per-file hash and the instruction addresses taken
# out, and prints "[sass] <kernel> identical" or the first lines that differ.
# Exits non-zero if a build fails or the SASS differs.
set -e
kernel=$1
old=$2
new=${3:-.}
cuda=${CUDA_HOME:-/usr/local/cuda}
flags="-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC"
mkdir -p build/sass
for side in old new; do
    root=${!side}
    $cuda/bin/nvcc $flags -o build/sass/${kernel}_$side.so \
        $root/deepspeed_tpu_torch/ops/csrc/$kernel.cu &
done
wait
for side in old new; do
    $cuda/bin/cuobjdump -sass build/sass/${kernel}_$side.so \
        | sed "s/_GLOBAL__N__[0-9a-f_]*${kernel}_cu_[0-9a-f]*//g; s/\/\*[0-9a-f]*\*\///g" \
        | grep -v "^\s*$\|arch = \|code for sm_\|Fatbin\|host = \|compile_size\|identifier" \
        > build/sass/${kernel}_$side.txt
done
echo "[sass] $kernel: $old $(wc -l < build/sass/${kernel}_old.txt) lines," \
     "$new $(wc -l < build/sass/${kernel}_new.txt) lines"
if cmp -s build/sass/${kernel}_old.txt build/sass/${kernel}_new.txt; then
    echo "[sass] $kernel identical"
else
    echo "[sass] $kernel differs:"
    diff build/sass/${kernel}_old.txt build/sass/${kernel}_new.txt | head -20
    exit 1
fi
