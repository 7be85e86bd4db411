// A native batch's per-window metadata in one call a batch, for the port's
// scan build (impop_tpu_torch/scanrun.py).  Built into the port's library
// beside cpp/*.cc and written only against cpp/capi.cc's C entry points,
// which it leaves as they are.
#include <cstdlib>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

extern "C" {

// cpp/capi.cc
void* ix_batch_result(void* batch, long long i);
int ix_batch_dims(void* batch, long long i, long long* n_out,
                  long long* s_out);
const char* ix_names_blob(void* result);
void ix_copy_site_pos(void* result, long long* out);

// Windows 0..count-1 of `batch` grouped by row set: two windows share one
// when their name blobs ("name\n" a row, sorted) are equal with each one's
// reference row, the first line equal to its region string regions[i],
// replaced by a NUL: the key of PanelMasks.row_set_key.  Keys are compared
// whole.  Writes set_of[i], the set of window i (-1 for a failed window),
// and first[k], the first window of set k, sets numbered in the order of
// their first windows; returns the number of sets.
long long ix_batch_row_sets(void* batch, long long count,
                            const char* const* regions, long long* set_of,
                            long long* first) {
  std::unordered_map<std::string, long long> sets;
  std::string key;
  for (long long i = 0; i < count; ++i) {
    set_of[i] = -1;
    void* r = ix_batch_result(batch, i);
    if (!r) continue;
    const std::string_view blob(ix_names_blob(r));
    const std::string_view ref(regions[i]);
    key.assign(blob);
    for (size_t at = 0; at < blob.size();) {
      const size_t end = blob.find('\n', at);
      if (end == std::string_view::npos) break;
      if (blob.substr(at, end - at) == ref) {
        key.replace(at, ref.size(), 1, '\0');
        break;
      }
      at = end + 1;
    }
    const auto [it, added] =
        sets.emplace(key, static_cast<long long>(sets.size()));
    if (added) first[it->second] = i;
    set_of[i] = it->second;
  }
  return static_cast<long long>(sets.size());
}

// For each window i, the index of its site nearest targets[i] (the first of
// equally near sites, as numpy's argmin) in index[i] and that site's
// position in pos[i]; -1 and -1 for a failed window or one without sites.
void ix_batch_nearest_sites(void* batch, long long count,
                            const long long* targets, long long* index,
                            long long* pos) {
  std::vector<long long> sites;
  for (long long i = 0; i < count; ++i) {
    index[i] = -1;
    pos[i] = -1;
    long long n = 0, s = 0;
    if (ix_batch_dims(batch, i, &n, &s) != 0 || s == 0) continue;
    sites.resize(static_cast<size_t>(s));
    ix_copy_site_pos(ix_batch_result(batch, i), sites.data());
    long long best = 0;
    long long best_gap = std::llabs(sites[0] - targets[i]);
    for (long long c = 1; c < s; ++c) {
      const long long gap = std::llabs(sites[static_cast<size_t>(c)] -
                                       targets[i]);
      if (gap < best_gap) {
        best = c;
        best_gap = gap;
      }
    }
    index[i] = best;
    pos[i] = sites[static_cast<size_t>(best)];
  }
}

}  // extern "C"
