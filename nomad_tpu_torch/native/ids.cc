// Bulk UUID formatting for the alloc-materialization path (the port's
// structs.generate_uuids binding; a copy of nomad_tpu/native/ids.cc with
// nids_format added).
//
// The batch scheduler mints every alloc id of a batch in one call;
// Python's per-id hex formatting costs about a microsecond each.  This
// formats the standard 8-4-4-4-12 form straight into one output buffer:
// nids_generate from getrandom() entropy, nids_format from given bytes
// (so the formatter can be held bit for bit against the Python twin).
//
// Plain C ABI for ctypes.  Build: g++ -O2 -std=c++17 -shared -fPIC at
// first use, into the repository's build/native/.

#include <cstdint>
#include <cstring>

#include <sys/random.h>

namespace {
const char* HEX = "0123456789abcdef";

// Dash positions in the 36-char uuid form.
inline void format_uuid(const uint8_t* raw, char* out) {
  static const int dash_after[16] = {0, 0, 0, 1, 0, 1, 0, 1,
                                     0, 1, 0, 0, 0, 0, 0, 0};
  char* p = out;
  for (int i = 0; i < 16; i++) {
    *p++ = HEX[raw[i] >> 4];
    *p++ = HEX[raw[i] & 0xF];
    if (dash_after[i]) *p++ = '-';
  }
}
}  // namespace

extern "C" {

// Fill out with n consecutive 36-char uuids (no separators, no NUL).
// Returns 0 on success, -1 if entropy could not be read.
int nids_generate(char* out, long n) {
  uint8_t raw[16 * 256];
  long done = 0;
  while (done < n) {
    long batch = n - done < 256 ? n - done : 256;
    size_t need = (size_t)batch * 16;
    size_t got = 0;
    while (got < need) {
      ssize_t r = getrandom(raw + got, need - got, 0);
      if (r < 0) return -1;
      got += (size_t)r;
    }
    for (long i = 0; i < batch; i++)
      format_uuid(raw + i * 16, out + (done + i) * 36);
    done += batch;
  }
  return 0;
}

// Format n uuids from raw (16 * n bytes) into out (36 * n chars, no
// separators, no NUL).  Returns 0.
int nids_format(const uint8_t* raw, long n, char* out) {
  for (long i = 0; i < n; i++) format_uuid(raw + i * 16, out + i * 36);
  return 0;
}

}  // extern "C"
