// Native cluster-scheduling policy engine.
//
// The reference implements node selection in C++ (ray:
// src/ray/raylet/scheduling/cluster_resource_scheduler.h, policies under
// src/ray/raylet/scheduling/policy/: hybrid_scheduling_policy.h:50,
// spread_scheduling_policy.h:27, node_affinity, node_label_scheduling_
// policy.h:25, bundle_scheduling_policy.h:82-106, scorer.h:41
// LeastResourceScorer; fixed-point resources in
// src/ray/common/scheduling/fixed_point.h). This is the port's
// equivalent: a stateless policy library with a C ABI that the Python
// raylet/GCS call through ctypes (ray_tpu_torch/_private/native_sched.py); the
// pure-Python policies in ray_tpu_torch/_private/common.py remain the fallback
// and the differential-test oracle — both sides must pick identical nodes.
//
// Wire format (no JSON dependency): the cluster view is a line-oriented
// blob, one node per line:
//   node_id|alive(0/1)|total|avail|labels
// where total/avail/labels are comma-separated k=v lists (resource values
// parsed as decimal, stored as 1e-4 fixed-point int64). A label selector is
// a comma-separated list of key:op:vals entries with op in {in, nin, ex,
// nex} and vals joined by ';'.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kQuant = 1e-4;  // 4-decimal fixed point

using ResMap = std::unordered_map<std::string, int64_t>;

int64_t ToFixed(double v) { return static_cast<int64_t>(std::llround(v / kQuant)); }

std::vector<std::string> Split(const std::string& s, char sep) {
  std::vector<std::string> out;
  size_t start = 0;
  while (true) {
    size_t pos = s.find(sep, start);
    if (pos == std::string::npos) {
      out.push_back(s.substr(start));
      return out;
    }
    out.push_back(s.substr(start, pos - start));
    start = pos + 1;
  }
}

ResMap ParseRes(const std::string& s) {
  ResMap out;
  if (s.empty()) return out;
  for (const auto& kv : Split(s, ',')) {
    size_t eq = kv.find('=');
    if (eq == std::string::npos) continue;
    out[kv.substr(0, eq)] = ToFixed(std::strtod(kv.c_str() + eq + 1, nullptr));
  }
  return out;
}

std::unordered_map<std::string, std::string> ParseLabels(const std::string& s) {
  std::unordered_map<std::string, std::string> out;
  if (s.empty()) return out;
  for (const auto& kv : Split(s, ',')) {
    size_t eq = kv.find('=');
    if (eq == std::string::npos) continue;
    out[kv.substr(0, eq)] = kv.substr(eq + 1);
  }
  return out;
}

struct Node {
  std::string id;
  bool alive = true;
  ResMap total;
  ResMap avail;
  std::unordered_map<std::string, std::string> labels;
};

std::vector<Node> ParseNodes(const char* blob) {
  std::vector<Node> nodes;
  if (blob == nullptr) return nodes;
  for (const auto& line : Split(blob, '\n')) {
    if (line.empty()) continue;
    auto f = Split(line, '|');
    if (f.size() < 4) continue;
    Node n;
    n.id = f[0];
    n.alive = f[1] == "1";
    n.total = ParseRes(f[2]);
    n.avail = ParseRes(f[3]);
    if (f.size() > 4) n.labels = ParseLabels(f[4]);
    nodes.push_back(std::move(n));
  }
  return nodes;
}

bool Fits(const ResMap& demand, const ResMap& have) {
  for (const auto& [k, v] : demand) {
    auto it = have.find(k);
    int64_t a = it == have.end() ? 0 : it->second;
    if (v > a) return false;
  }
  return true;
}

// LeastResourceScorer (ray: scorer.h:41): mean over resources of the
// remaining-after-placement fraction; higher = more headroom left.
double Score(const Node& n, const ResMap& demand) {
  double sum = 0.0;
  int cnt = 0;
  for (const auto& [k, total] : n.total) {
    if (total <= 0) continue;
    auto it = n.avail.find(k);
    int64_t avail = it == n.avail.end() ? 0 : it->second;
    auto dit = demand.find(k);
    if (dit != demand.end()) avail -= dit->second;
    if (avail < 0) avail = 0;
    sum += static_cast<double>(avail) / static_cast<double>(total);
    ++cnt;
  }
  return cnt == 0 ? 0.0 : sum / cnt;
}

const Node* PickHybrid(const std::vector<Node>& nodes, const ResMap& demand,
                       const std::string& local, double spread_threshold) {
  std::vector<const Node*> feasible;
  for (const auto& n : nodes)
    if (n.alive && Fits(demand, n.total)) feasible.push_back(&n);
  if (feasible.empty()) return nullptr;
  std::sort(feasible.begin(), feasible.end(),
            [&](const Node* a, const Node* b) {
              bool al = a->id != local, bl = b->id != local;
              return al != bl ? al < bl : a->id < b->id;
            });
  const Node* best = nullptr;
  double best_score = -1.0;
  static const ResMap kEmpty;
  for (const Node* n : feasible) {
    if (!Fits(demand, n->avail)) continue;
    double util = 1.0 - Score(*n, kEmpty);
    if (util <= spread_threshold) return n;
    double sc = Score(*n, demand);
    if (sc > best_score) {
      best = n;
      best_score = sc;
    }
  }
  return best;
}

const Node* PickSpread(const std::vector<Node>& nodes, const ResMap& demand,
                       long long* rr_state) {
  std::vector<const Node*> feasible;
  for (const auto& n : nodes)
    if (n.alive && Fits(demand, n.avail)) feasible.push_back(&n);
  if (feasible.empty()) {
    for (const auto& n : nodes)
      if (n.alive && Fits(demand, n.total)) feasible.push_back(&n);
  }
  if (feasible.empty()) return nullptr;
  std::sort(feasible.begin(), feasible.end(),
            [](const Node* a, const Node* b) { return a->id < b->id; });
  *rr_state = (*rr_state + 1) % static_cast<long long>(feasible.size());
  return feasible[*rr_state];
}

struct LabelCond {
  std::string key;
  std::string op;  // in | nin | ex | nex
  std::vector<std::string> vals;
};

std::vector<LabelCond> ParseSelector(const char* s) {
  std::vector<LabelCond> out;
  if (s == nullptr || *s == '\0') return out;
  for (const auto& ent : Split(s, ',')) {
    auto f = Split(ent, ':');
    if (f.size() < 2) continue;
    LabelCond c;
    c.key = f[0];
    c.op = f[1];
    if (f.size() > 2 && !f[2].empty()) c.vals = Split(f[2], ';');
    out.push_back(std::move(c));
  }
  return out;
}

bool MatchLabels(const Node& n, const std::vector<LabelCond>& sel) {
  for (const auto& c : sel) {
    auto it = n.labels.find(c.key);
    bool has = it != n.labels.end();
    if (c.op == "ex") {
      if (!has) return false;
    } else if (c.op == "nex") {
      if (has) return false;
    } else if (c.op == "in") {
      if (!has) return false;
      if (std::find(c.vals.begin(), c.vals.end(), it->second) == c.vals.end())
        return false;
    } else if (c.op == "nin") {
      if (has && std::find(c.vals.begin(), c.vals.end(), it->second) !=
                     c.vals.end())
        return false;
    }
  }
  return true;
}

// Node-label policy (ray: node_label_scheduling_policy.h:25): hard
// constraints filter; among feasible nodes prefer soft-matching ones with
// available capacity, then any with available capacity, then any feasible
// by total (task waits there); pick the least-utilized-after-placement.
const Node* PickLabels(const std::vector<Node>& nodes, const ResMap& demand,
                       const std::vector<LabelCond>& hard,
                       const std::vector<LabelCond>& soft) {
  std::vector<const Node*> cands;
  for (const auto& n : nodes)
    if (n.alive && MatchLabels(n, hard) && Fits(demand, n.total))
      cands.push_back(&n);
  if (cands.empty()) return nullptr;
  std::vector<const Node*> avail, pref;
  for (const Node* n : cands)
    if (Fits(demand, n->avail)) avail.push_back(n);
  for (const Node* n : avail)
    if (MatchLabels(*n, soft)) pref.push_back(n);
  const std::vector<const Node*>& pool =
      !pref.empty() ? pref : (!avail.empty() ? avail : cands);
  const Node* best = nullptr;
  double best_score = -2.0;
  std::vector<const Node*> ordered(pool);
  std::sort(ordered.begin(), ordered.end(),
            [](const Node* a, const Node* b) { return a->id < b->id; });
  for (const Node* n : ordered) {
    double sc = Score(*n, demand);
    if (sc > best_score) {
      best = n;
      best_score = sc;
    }
  }
  return best;
}

int WriteOut(const std::string& s, char* out, unsigned long cap) {
  if (s.size() + 1 > cap) return 0;
  std::memcpy(out, s.c_str(), s.size() + 1);
  return 1;
}

}  // namespace

extern "C" {

// Pick a node for one task. kind: DEFAULT | SPREAD | NODE_AFFINITY |
// NODE_LABEL. Returns 1 + node id in `out` on success, 0 if infeasible.
// rr_state is the caller-owned round-robin cursor for SPREAD.
int rtpu_sched_pick(const char* nodes_blob, const char* demand_s,
                    const char* kind, const char* affinity_node, int soft,
                    const char* hard_sel, const char* soft_sel,
                    const char* local_node, double spread_threshold,
                    long long* rr_state, char* out, unsigned long out_cap) {
  auto nodes = ParseNodes(nodes_blob);
  ResMap demand = ParseRes(demand_s ? demand_s : "");
  std::string k = kind ? kind : "DEFAULT";
  std::string local = local_node ? local_node : "";
  const Node* picked = nullptr;
  if (k == "NODE_AFFINITY") {
    std::string want = affinity_node ? affinity_node : "";
    for (const auto& n : nodes)
      if (n.id == want && n.alive && Fits(demand, n.total)) picked = &n;
    if (picked == nullptr && soft)
      picked = PickHybrid(nodes, demand, local, spread_threshold);
  } else if (k == "SPREAD") {
    long long rr = rr_state ? *rr_state : 0;
    picked = PickSpread(nodes, demand, &rr);
    if (rr_state) *rr_state = rr;
  } else if (k == "NODE_LABEL") {
    picked = PickLabels(nodes, demand, ParseSelector(hard_sel),
                        ParseSelector(soft_sel));
  } else {
    picked = PickHybrid(nodes, demand, local, spread_threshold);
  }
  if (picked == nullptr) return 0;
  return WriteOut(picked->id, out, out_cap);
}

// Placement-group bundle placement (ray: bundle_scheduling_policy.h:82-106).
// bundles_blob: one bundle per line as a k=v list. strategy: PACK | SPREAD |
// STRICT_PACK | STRICT_SPREAD. On success writes newline-joined node ids
// (one per bundle, input order) and returns 1; returns 0 if infeasible.
int rtpu_sched_place_bundles(const char* nodes_blob, const char* bundles_blob,
                             const char* strategy, char* out,
                             unsigned long out_cap) {
  auto nodes = ParseNodes(nodes_blob);
  std::vector<ResMap> bundles;
  for (const auto& line : Split(bundles_blob ? bundles_blob : "", '\n')) {
    if (!line.empty()) bundles.push_back(ParseRes(line));
  }
  std::string strat = strategy ? strategy : "PACK";
  std::vector<Node*> alive;  // input order, like the Python oracle
  for (auto& n : nodes)
    if (n.alive) alive.push_back(&n);
  std::unordered_map<std::string, ResMap> avail;
  for (Node* n : alive) avail[n->id] = n->avail;

  auto sum_bundle = [](const ResMap& b) {
    int64_t s = 0;
    for (const auto& [k, v] : b) s += v;
    return s;
  };
  std::vector<size_t> order(bundles.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](size_t a, size_t b) {
    return sum_bundle(bundles[a]) > sum_bundle(bundles[b]);
  });

  std::vector<std::string> placement(bundles.size());
  auto fits_and_take = [&](const std::string& nid, const ResMap& b) {
    ResMap& av = avail[nid];
    if (!Fits(b, av)) return false;
    for (const auto& [k, v] : b) av[k] -= v;
    return true;
  };

  auto emit = [&]() {
    std::string joined;
    for (size_t i = 0; i < placement.size(); ++i) {
      if (i) joined += '\n';
      joined += placement[i];
    }
    return WriteOut(joined, out, out_cap);
  };

  if (strat == "STRICT_PACK") {
    for (Node* n : alive) {
      ResMap tmp = avail[n->id];
      bool ok = true;
      for (const auto& b : bundles) {
        if (Fits(b, tmp)) {
          for (const auto& [k, v] : b) tmp[k] -= v;
        } else {
          ok = false;
          break;
        }
      }
      if (ok) {
        for (auto& p : placement) p = n->id;
        return emit();
      }
    }
    return 0;
  }
  if (strat == "STRICT_SPREAD") {
    std::vector<Node*> by_id(alive);
    std::sort(by_id.begin(), by_id.end(),
              [](Node* a, Node* b) { return a->id < b->id; });
    std::unordered_map<std::string, bool> used;
    for (size_t i : order) {
      bool placed = false;
      for (Node* n : by_id) {
        if (used.count(n->id)) continue;
        if (fits_and_take(n->id, bundles[i])) {
          placement[i] = n->id;
          used[n->id] = true;
          placed = true;
          break;
        }
      }
      if (!placed) return 0;
    }
    return emit();
  }
  // PACK: prefer already-used nodes; SPREAD: prefer distinct but allow reuse.
  bool prefer_distinct = strat == "SPREAD";
  std::unordered_map<std::string, bool> used;
  for (size_t i : order) {
    std::vector<Node*> cand(alive);
    std::sort(cand.begin(), cand.end(), [&](Node* a, Node* b) {
      bool au = (used.count(a->id) > 0) == prefer_distinct;
      bool bu = (used.count(b->id) > 0) == prefer_distinct;
      return au != bu ? au < bu : a->id < b->id;
    });
    bool placed = false;
    for (Node* n : cand) {
      if (fits_and_take(n->id, bundles[i])) {
        placement[i] = n->id;
        used[n->id] = true;
        placed = true;
        break;
      }
    }
    if (!placed) return 0;
  }
  return emit();
}

}  // extern "C"
