// Native ingest kernels for the host data plane (the port's copy of the
// JAX package's native/wfdb_native.cpp; built by data/native.py).
//
// The byte-level hot loops of WFDB ingest in C++ with a C ABI consumed from
// Python via ctypes:
//
//   * decode_fmt212 / decode_fmt16 / decode_fmt24 / decode_fmt80:
//     packed-sample unpacking (fmt 212 = two 12-bit samples per 3 bytes,
//     INCART's format) into int32.
//   * dig2phys: (digital - baseline) / gain with per-format NaN sentinels.
//   * read_records_16: multi-threaded batch read of N same-shape fmt-16
//     records straight into one preallocated (N, C, L) float32 buffer --
//     it skips per-record numpy allocation and GIL round-trips.
//
// Physical units are (float)(d - baseline) / (float)gain, a correctly
// rounded f32 division: the numpy reader (data/readers.py) computes exactly
// that, so the two paths agree bit for bit.  (A multiply by the rounded
// reciprocal 1/gain differs from it in the last bit for about a quarter of
// the int16 values at gain 200.)
//
// Build: data/native.py compiles this file with the host compiler at first
// use into build/torch_kernels/ (pure-numpy fallback when there is none).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>
#include <atomic>

extern "C" {

// ---- packed-format decoders -------------------------------------------------

// fmt 212: bytes b0 b1 b2 -> s0 = ((b1 & 0x0F) << 8) | b0 ; s1 = ((b1 & 0xF0) << 4) | b2
// sign-extended from 12 bits.
void decode_fmt212(const uint8_t* raw, int64_t n_bytes, int32_t* out, int64_t n_values) {
    int64_t n_triplets = n_bytes / 3;
    int64_t v = 0;
    for (int64_t t = 0; t < n_triplets && v < n_values; ++t) {
        const uint8_t* b = raw + 3 * t;
        int32_t s0 = ((b[1] & 0x0F) << 8) | b[0];
        int32_t s1 = ((b[1] & 0xF0) << 4) | b[2];
        if (s0 > 2047) s0 -= 4096;
        if (s1 > 2047) s1 -= 4096;
        out[v++] = s0;
        if (v < n_values) out[v++] = s1;
    }
    // odd sample count: the file ends with a 2-byte group holding one final
    // sample (total ceil(1.5*n) bytes, signal(5)) -- decode, don't drop it
    if (v < n_values && n_bytes - 3 * n_triplets >= 2) {
        const uint8_t* b = raw + 3 * n_triplets;
        int32_t s0 = ((b[1] & 0x0F) << 8) | b[0];
        if (s0 > 2047) s0 -= 4096;
        out[v++] = s0;
    }
}

void decode_fmt16(const uint8_t* raw, int64_t n_bytes, int32_t* out, int64_t n_values) {
    int64_t n = n_bytes / 2;
    if (n > n_values) n = n_values;
    const int16_t* p = reinterpret_cast<const int16_t*>(raw);
    for (int64_t i = 0; i < n; ++i) out[i] = p[i];
}

void decode_fmt24(const uint8_t* raw, int64_t n_bytes, int32_t* out, int64_t n_values) {
    int64_t n = n_bytes / 3;
    if (n > n_values) n = n_values;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* b = raw + 3 * i;
        int32_t v = b[0] | (b[1] << 8) | (b[2] << 16);
        if (v >= (1 << 23)) v -= (1 << 24);
        out[i] = v;
    }
}

void decode_fmt80(const uint8_t* raw, int64_t n_bytes, int32_t* out, int64_t n_values) {
    int64_t n = n_bytes < n_values ? n_bytes : n_values;
    for (int64_t i = 0; i < n; ++i) out[i] = (int32_t)raw[i] - 128;
}

// ---- digital -> physical ----------------------------------------------------

void dig2phys(const int32_t* dig, int64_t n, double gain, int32_t baseline,
              int32_t nan_sentinel, int has_sentinel, float* out) {
    const float g = (float)gain;
    for (int64_t i = 0; i < n; ++i) {
        int32_t d = dig[i];
        if (has_sentinel && d == nan_sentinel) {
            out[i] = NAN;
        } else {
            out[i] = (float)(d - baseline) / g;
        }
    }
}

// ---- threaded batch reader for same-shape fmt-16 records --------------------
//
// paths: concatenated NUL-separated file paths (n_records of them).
// Each file holds n_ch interleaved int16 channels of n_samples frames,
// preceded by offsets[i] bytes to skip (the CinC '.mat' corpora carry a
// 24-byte MATLAB header before the samples -- '16+24' in the .hea dtype).
// gains/baselines: per (record, channel).  Output: (n_records, n_ch, n_samples) f32.
// Returns the number of records read successfully.
int64_t read_records_16(const char* paths, int64_t n_records,
                        int32_t n_ch, int64_t n_samples,
                        const double* gains, const int32_t* baselines,
                        const int64_t* offsets,
                        float* out, int32_t n_threads) {
    // split path list
    std::vector<const char*> path_v;
    path_v.reserve(n_records);
    const char* p = paths;
    for (int64_t i = 0; i < n_records; ++i) {
        path_v.push_back(p);
        p += strlen(p) + 1;
    }
    std::atomic<int64_t> next(0), ok(0);
    const int64_t rec_elems = (int64_t)n_ch * n_samples;

    auto worker = [&]() {
        std::vector<int16_t> buf(rec_elems);
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n_records) return;
            FILE* f = fopen(path_v[i], "rb");
            if (!f) continue;
            if (offsets && offsets[i] > 0 &&
                fseek(f, (long)offsets[i], SEEK_SET) != 0) {
                fclose(f);
                continue;
            }
            size_t got = fread(buf.data(), sizeof(int16_t), rec_elems, f);
            fclose(f);
            if ((int64_t)got < rec_elems) continue;
            float* dst = out + i * rec_elems;
            for (int32_t c = 0; c < n_ch; ++c) {
                const float g = (float)gains[i * n_ch + c];
                const int32_t base = baselines[i * n_ch + c];
                float* row = dst + (int64_t)c * n_samples;
                for (int64_t s = 0; s < n_samples; ++s) {
                    int16_t d = buf[s * n_ch + c];     // interleaved by frame
                    row[s] = (d == -32768) ? NAN : (float)(d - base) / g;
                }
            }
            ok.fetch_add(1);
        }
    };

    if (n_threads < 1) n_threads = 1;
    std::vector<std::thread> pool;
    for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return ok.load();
}

}  // extern "C"
