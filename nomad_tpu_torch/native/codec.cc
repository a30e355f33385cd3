// Struct-codec inner loops (the port's codec/native.py binding; a copy
// of nomad_tpu/native/codec.cc).
//
// The hot shape is a string column: tens of thousands of short strings
// (uuids, alloc names, node ids) framed as varint length + utf8 bytes.
// Python pays per-item interpreter dispatch for the varint arithmetic;
// these two functions do the whole column in one C pass.  The pure-
// Python twin in codec/native.py is the format's reference: the
// differential guard bit-compares outputs at a cadence the module sets.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC at first use, into the
// repository's build/native/ (nomad_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>

extern "C" {

// Total packed size of a column: per item, varint(len) + len bytes.
long ncodec_packed_size(const int32_t* lens, long n) {
    long total = 0;
    for (long i = 0; i < n; i++) {
        uint32_t v = (uint32_t)lens[i];
        total += lens[i] + 1;
        while (v > 0x7F) { total++; v >>= 7; }
    }
    return total;
}

// Pack: concat holds the items back to back (lengths in lens); out must
// have capacity cap >= ncodec_packed_size.  Returns bytes written, or
// -1 when the output would overflow.
long ncodec_pack_strs(const char* concat, const int32_t* lens, long n,
                      char* out, long cap) {
    long ip = 0, op = 0;
    for (long i = 0; i < n; i++) {
        uint32_t v = (uint32_t)lens[i];
        while (v > 0x7F) {
            if (op >= cap) return -1;
            out[op++] = (char)(0x80 | (v & 0x7F));
            v >>= 7;
        }
        if (op >= cap) return -1;
        out[op++] = (char)v;
        if (op + lens[i] > cap) return -1;
        std::memcpy(out + op, concat + ip, lens[i]);
        op += lens[i];
        ip += lens[i];
    }
    return op;
}

// Split: parse n varint-prefixed items from buf[start..avail), filling
// lens[i] and offs[i] (offsets into buf of each item's payload — the
// caller passes the WHOLE frame + a start offset so no Python-side
// slice copy is needed).  Returns the end position, or -1 on
// truncation/overflow.
long ncodec_split_strs(const char* buf, long start, long avail, long n,
                       int32_t* lens, int32_t* offs) {
    long p = start;
    for (long i = 0; i < n; i++) {
        uint32_t size = 0;
        int shift = 0;
        for (;;) {
            if (p >= avail) return -1;
            uint8_t c = (uint8_t)buf[p++];
            size |= (uint32_t)(c & 0x7F) << shift;
            if (!(c & 0x80)) break;
            shift += 7;
            if (shift > 28) return -1;  // > int32: not a sane string
        }
        if ((long)size > avail - p) return -1;
        if (p > 0x7FFFFFFFL) return -1;  // offsets must fit int32
        offs[i] = (int32_t)p;
        lens[i] = (int32_t)size;
        p += size;
    }
    return p;
}

}  // extern "C"
