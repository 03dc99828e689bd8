// Host-side batch marshalling for the serving step loop (the JAX package's
// qserve_tpu/native/marshal.cpp, this package's own copy).
//
// The reference does its per-step input assembly with torch tensor ops and
// raw pointer arithmetic in Python (qserve/worker/model_runner.py:333-611:
// _prepare_prompt / _prepare_decode_ifb build token/context/pointer tables
// per step). Here the equivalent work (flattening scheduler state into the
// padded int32 arrays a step's launches consume) runs in C++.
//
// Plain C ABI over int32 numpy buffers, loaded via ctypes (no pybind11).
// Every function is allocation-free: the caller provides output buffers.

#include <cstdint>
#include <cstring>

extern "C" {

// Decode batch: per sequence, one current token + context length + page row.
// tables_flat / table_offsets: concatenated page tables (offsets has n+1
// entries). Outputs are pre-zeroed by the caller or zeroed here.
void qs_pack_decode(
    int32_t n,
    const int32_t* last_tokens,   // [n]
    const int32_t* ctx_lens,      // [n]
    const int32_t* tables_flat,
    const int32_t* table_offsets, // [n+1]
    int32_t B_pad,
    int32_t maxP,
    int32_t* out_tokens,          // [B_pad]
    int32_t* out_ctx,             // [B_pad]
    int32_t* out_bt               // [B_pad * maxP]
) {
    memset(out_tokens, 0, sizeof(int32_t) * B_pad);
    memset(out_ctx, 0, sizeof(int32_t) * B_pad);
    memset(out_bt, 0, sizeof(int32_t) * (size_t)B_pad * maxP);
    for (int32_t i = 0; i < n; ++i) {
        out_tokens[i] = last_tokens[i];
        out_ctx[i] = ctx_lens[i];
        const int32_t lo = table_offsets[i];
        int32_t len = table_offsets[i + 1] - lo;
        if (len > maxP) len = maxP;
        memcpy(out_bt + (size_t)i * maxP, tables_flat + lo,
               sizeof(int32_t) * len);
    }
}

// Prefill stream packing: concatenate prompts into one token stream with
// positions / segment ids / destination pages / slots, plus last-token index
// per sequence. image_token (e.g. -200) positions get img_idx assigned in
// stream order; pass image_token = INT32_MIN to disable.
// Returns the total (unpadded) token count, or -1 if the prompts would
// overflow T_pad / B_pad or a prompt outruns its page table — callers
// normally guarantee capacity via the scheduler + bucket(), but a miscount
// must surface as a Python exception, not silent heap corruption.
int32_t qs_pack_prefill(
    int32_t n,
    const int32_t* prompts_flat,   // chunk tokens (already sliced)
    const int32_t* prompt_offsets, // [n+1]
    const int32_t* tables_flat,
    const int32_t* table_offsets,  // [n+1]
    const int32_t* starts,         // [n] absolute start position per prompt
    int32_t block_size,
    int32_t image_token,
    int32_t T_pad,
    int32_t B_pad,
    int32_t* out_tokens,    // [T_pad]
    int32_t* out_positions, // [T_pad]
    int32_t* out_segids,    // [T_pad]
    int32_t* out_pages,     // [T_pad]
    int32_t* out_slots,     // [T_pad]
    int32_t* out_img_idx,   // [T_pad]
    int32_t* out_last_idx   // [B_pad]
) {
    memset(out_tokens, 0, sizeof(int32_t) * T_pad);
    memset(out_positions, 0, sizeof(int32_t) * T_pad);
    memset(out_segids, 0, sizeof(int32_t) * T_pad);
    for (int32_t t = 0; t < T_pad; ++t) out_pages[t] = -1;
    memset(out_slots, 0, sizeof(int32_t) * T_pad);
    memset(out_img_idx, 0, sizeof(int32_t) * T_pad);
    memset(out_last_idx, 0, sizeof(int32_t) * B_pad);

    if (n > B_pad) return -1;
    int32_t t = 0;
    int32_t n_img_tok = 0;
    for (int32_t i = 0; i < n; ++i) {
        const int32_t* prompt = prompts_flat + prompt_offsets[i];
        const int32_t plen = prompt_offsets[i + 1] - prompt_offsets[i];
        const int32_t* table = tables_flat + table_offsets[i];
        const int32_t tlen = table_offsets[i + 1] - table_offsets[i];
        const int32_t s0 = starts ? starts[i] : 0;
        if (t + plen > T_pad) return -1;
        if (plen > 0 && (s0 + plen - 1) / block_size >= tlen) return -1;
        for (int32_t p = 0; p < plen; ++p, ++t) {
            out_tokens[t] = prompt[p];
            out_positions[t] = s0 + p;
            out_segids[t] = i + 1;
            out_pages[t] = table[(s0 + p) / block_size];
            out_slots[t] = (s0 + p) % block_size;
            if (prompt[p] == image_token) {
                out_img_idx[t] = n_img_tok++;
            }
        }
        out_last_idx[i] = t - 1;
    }
    return t;
}

// Page-table row fill for a padded [B_pad, maxP] table (prefill sampling
// metadata reuse); kept separate so Python can fill decode tables without
// rebuilding offsets.
void qs_fill_block_table(
    int32_t n,
    const int32_t* tables_flat,
    const int32_t* table_offsets,
    int32_t B_pad,
    int32_t maxP,
    int32_t* out_bt
) {
    memset(out_bt, 0, sizeof(int32_t) * (size_t)B_pad * maxP);
    for (int32_t i = 0; i < n; ++i) {
        const int32_t lo = table_offsets[i];
        int32_t len = table_offsets[i + 1] - lo;
        if (len > maxP) len = maxP;
        memcpy(out_bt + (size_t)i * maxP, tables_flat + lo,
               sizeof(int32_t) * len);
    }
}

}  // extern "C"
