// TF32 tensor-core helpers shared by the kernels that take their products
// on the tensor cores in 3xTF32 (csrc/kmeans_assign.cu, csrc/linear_attn.cu):
// a float is split into a TF32 "big" part and a TF32 "small" remainder, and
// a x b is taken as small_a big_b + big_a small_b + big_a big_b.

#pragma once

// a = big + small + (a residual below 2^-22 |a|): big = rna_tf32(a), small =
// rna_tf32(a - big); a - big is exact in fp32.
__device__ __forceinline__ void split_tf32(float a, unsigned& big, unsigned& small) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(a));
    const float r = __fsub_rn(a, __uint_as_float(big));
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(r));
}

// d += a (16 x 8, row) * b (8 x 8, col) on the tensor cores, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
